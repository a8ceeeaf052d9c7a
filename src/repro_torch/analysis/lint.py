"""Source lint (RL4xx): the port's conventions enforced mechanically.

The port of the reference's ``repro.analysis.lint``: AST-based (no regexes
over code), ruff-style output, scoped to ``src/repro_torch``, each rule in
the port's idiom:

  RL401  a ``P(...)`` (or ``PartitionSpec``) call with a **string-literal
         mesh axis** outside ``repro_torch/dist/`` — naming an axis inline
         is declaring placement policy, which belongs to the pspec families
         in ``dist/sharding.py``. Axis-less literals (``P(None)``,
         ``P(dp, None)``) and literals passed *directly* to
         ``maybe_shard``/``shard_batch_dim`` stay legal.
  RL402  a raw collective outside ``repro_torch/dist/``: a call of
         ``torch.distributed``'s ``all_reduce``, ``all_to_all_single``,
         ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
         ``broadcast`` (or their kin), through the module or a name
         imported from it. The port has no ``shard_map``; its counterpart
         is a collective issued anywhere but the ``dist/shard.py`` helpers,
         which record each one for the walk (SC204, BC5xx).
  RL403  host syncs in ``repro_torch/serve/``: ``.item()``, ``.cpu()``,
         ``.tolist()``, ``torch.cuda.synchronize`` — a sync in the hot path
         serializes the dispatch pipeline. The deliberate ones (timing
         barriers, a request's answer read back) carry
         ``# staticcheck: ignore[RL403]`` with their reason.
  RL404  a ``torch.float64`` / ``torch.double`` dtype literal — doubles
         are never incidental on the device path (PF101 is the trace-level
         twin). The port's deliberate float64 sums carry the pragma with
         their reason. Host-side ``np.float64`` stays legal.
  RL405  nondeterminism in a cell-definition module (``serve/cells.py``,
         ``launch/cells.py``): ``time.*``/``random.*``/``np.random.*``/
         ``datetime.*`` and torch's RNG calls — a cell must walk the same
         ops every process (RC304 is the trace-level twin).
"""
from __future__ import annotations

import ast
import os

from repro_torch.analysis.findings import Finding, parse_pragmas

RULES = ("RL401", "RL402", "RL403", "RL404", "RL405")

_PSPEC_NAMES = {"P", "PartitionSpec"}
_SHARD_WRAPPERS = {"maybe_shard", "shard_batch_dim"}
_CELL_MODULES = ("serve/cells.py", "launch/cells.py")
_NONDET_ROOTS = {"time", "random", "datetime"}
_TORCH_RNG = {"rand", "randn", "randint", "randperm", "rand_like",
              "randn_like", "randint_like", "manual_seed", "seed",
              "bernoulli", "multinomial", "normal"}
_COLLECTIVES = {"all_reduce", "all_to_all_single", "all_to_all",
                "all_gather_into_tensor", "all_gather_single", "all_gather",
                "reduce_scatter_tensor", "reduce_scatter_single",
                "reduce_scatter", "broadcast", "reduce", "gather", "scatter"}
_HOST_SYNCS = {"item", "cpu", "tolist"}


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _in_dist(path: str) -> bool:
    return "/dist/" in _norm(path) or _norm(path).endswith("/dist")


def _in_serve(path: str) -> bool:
    return "repro_torch/serve/" in _norm(path)


def _is_cell_module(path: str) -> bool:
    return any(_norm(path).endswith(m) for m in _CELL_MODULES)


def _call_name(node: ast.Call) -> str | None:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _dotted(node) -> str | None:
    """``a.b.c`` of a dotted expression, None for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _dotted_root(node) -> str | None:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _has_axis_literal(call: ast.Call) -> bool:
    """Does a P(...) call name a mesh axis as a string literal (directly or
    inside a tuple literal)?"""
    for arg in call.args:
        entries = arg.elts if isinstance(arg, ast.Tuple) else (arg,)
        for e in entries:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                return True
    return False


class _Visitor(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.relpath = relpath
        self.findings: list[Finding] = []
        self._wrapper_args: set[int] = set()  # ids of maybe_shard arg nodes
        self._dist_names = {"torch.distributed"}  # names bound to the module
        self._collective_names: set[str] = set()  # collectives imported bare

    def _flag(self, code: str, node, message: str):
        self.findings.append(Finding(
            code, message, self.relpath, file=self.relpath,
            line=node.lineno, col=node.col_offset + 1))

    # -- the names torch.distributed goes by in this module -----------------
    def visit_Import(self, node: ast.Import):
        for a in node.names:
            if a.name == "torch.distributed" and a.asname:
                self._dist_names.add(a.asname)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        for a in node.names:
            if node.module == "torch" and a.name == "distributed":
                self._dist_names.add(a.asname or a.name)
            elif node.module == "torch.distributed" \
                    and a.name in _COLLECTIVES:
                self._collective_names.add(a.asname or a.name)
        self.generic_visit(node)

    def _is_collective(self, node: ast.Call) -> bool:
        fn = node.func
        if isinstance(fn, ast.Name):
            return fn.id in self._collective_names
        if isinstance(fn, ast.Attribute) and fn.attr in _COLLECTIVES:
            return _dotted(fn.value) in self._dist_names
        return False

    def visit_Call(self, node: ast.Call):
        name = _call_name(node)

        if name in _SHARD_WRAPPERS:
            for arg in node.args:
                if isinstance(arg, ast.Call) and \
                        _call_name(arg) in _PSPEC_NAMES:
                    self._wrapper_args.add(id(arg))

        if name in _PSPEC_NAMES and not _in_dist(self.relpath) \
                and id(node) not in self._wrapper_args \
                and _has_axis_literal(node):
            self._flag("RL401", node,
                       "hand-rolled PartitionSpec with a string-literal "
                       "mesh axis — use a pspec family from "
                       "dist/sharding.py (or pass it directly to "
                       "maybe_shard)")

        if not _in_dist(self.relpath) and self._is_collective(node):
            self._flag("RL402", node,
                       f"raw collective {name} outside dist/ — use the "
                       f"dist/shard.py helpers (psum, all_gather, "
                       f"all_to_all), which the walk records")

        if _in_serve(self.relpath):
            fn = node.func
            if (isinstance(fn, ast.Attribute) and fn.attr in _HOST_SYNCS
                    and not node.args) or \
                    _dotted(fn) == "torch.cuda.synchronize":
                self._flag("RL403", node,
                           f"{name} in the serve hot path — host syncs "
                           f"serialize the dispatch pipeline")

        if _is_cell_module(self.relpath):
            root = _dotted_root(node.func)
            attr = node.func.attr if isinstance(node.func, ast.Attribute) \
                else None
            if root in _NONDET_ROOTS or (root == "np" and attr is not None
                                         and "random" in ast.dump(node.func)) \
                    or (root == "torch" and attr in _TORCH_RNG):
                self._flag("RL405", node,
                           f"nondeterministic call in a cell-definition "
                           f"module ({root}.{attr or name}) — a cell must "
                           f"walk the same ops every process")

        self.generic_visit(node)

    # -- RL404: float64 dtype literals ---------------------------------------
    def visit_Attribute(self, node: ast.Attribute):
        if node.attr in ("float64", "double") and \
                _dotted_root(node) == "torch":
            self._flag("RL404", node,
                       f"float64 dtype literal (torch.{node.attr}) — "
                       f"double precision is never incidental on the "
                       f"device path")
        self.generic_visit(node)


def lint_source(source: str, relpath: str) -> list[Finding]:
    """Lint one module's source text; pragma suppression applied."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("RL400", f"syntax error: {e.msg}", relpath,
                        file=relpath, line=e.lineno or 1)]
    visitor = _Visitor(relpath)
    visitor.visit(tree)
    pragmas = parse_pragmas(source)
    out = []
    for f in visitor.findings:
        codes = pragmas.get(f.line, ())
        if codes is None or f.code in codes:
            continue
        out.append(f)
    return out


def lint_file(path: str, root: str | None = None) -> list[Finding]:
    rel = os.path.relpath(path, root) if root else path
    with open(path) as f:
        return lint_source(f.read(), _norm(rel))


def lint_tree(src_root: str) -> list[Finding]:
    """Lint every ``.py`` under ``src_root`` (pass the repo root; scope is
    ``src/repro_torch``)."""
    target = os.path.join(src_root, "src", "repro_torch")
    findings = []
    for dirpath, dirs, files in os.walk(target):
        dirs.sort()
        for fn in sorted(files):
            if fn.endswith(".py"):
                findings += lint_file(os.path.join(dirpath, fn),
                                      root=src_root)
    return findings
