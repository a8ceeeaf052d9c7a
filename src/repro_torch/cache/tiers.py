"""Hot/cold tiered storage for MPE packed tables.

The port of the reference's ``repro.cache.tiers``. MPE's frequency-grouped
precision assignment (paper §3.2/§4.1) hands the serving layer a cache
policy: the frequent features, which get wide precision, are the rows worth
keeping on the card, while the long tail lives in host memory and moves per
request as packed words.

``TieredTableStore`` splits each per-width packed subtable of a
``core.inference.build_packed_table`` table into

  - a **hot tier**: the top-``hot_fraction`` features by frequency, kept as
    tensors on the store's device (``hot``, the reference's tree and keys);
  - a **cold tier**: every packed row in a host mirror (numpy). A lookup
    that touches cold rows gathers their *packed words* on the host and
    moves only those bytes to the card, so the transfer keeps the table's
    compression ratio.

A lookup is two kernels. The hot tier goes through the port's packed lookup
(``csrc/mpe_lookup.cu``) over the store's lookup view (``lookup_view``):
the hot subtables, ``local_idx = tier_local``, α and β, and a width index
that is -1 at every cold feature, where the kernel (and its plain version)
gives the zero row. The cold rows, staged by ``prefetch_cold`` in one
compact buffer (per width its count, the rows' positions, their packed
words), are written over those zeros by the cold fill
(``csrc/tiered_cold.cu``). Both dequantize ``α_b · code + β`` with one
rounding (an FMA), the rule of the port's ``packed_lookup``, so a tiered
lookup is bit-identical to the monolithic one at every hot fraction. The
reference's own cold path dequantizes eagerly, with two roundings, and is
within one float32 ulp of it.

The store is an **inclusive cache**, as the reference's: the host mirror
holds every packed row (indexed by ``local_idx``), the hot tier device
copies of the resident subset. A demotion flips the tier bit, a promotion
copies one mirror row into a free hot slot, a ``writeback`` writes the
mirror first and then patches a resident copy. Where the reference builds
new arrays and rebinds them, the port **writes its device tensors in
place** (``apply_moves``, ``writeback``, ``refresh``), on the current
stream, between serving rounds: every tensor keeps its shape and its
``data_ptr``, so the CUDA graphs of the tiered cells, which read them by
address, see every move without a recapture. Integer results — routing
vectors, packed words, counters, free slots — are the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.inference import _auto_pad_multiple, _pad_rows
from repro_torch.core.quantizer import int_bounds, quantize_codes
from repro_torch.device import resolve_device
from repro_torch.embeddings.frequency import hot_feature_mask
from repro_torch.kernels.mpe_lookup.ops import packed_lookup
from repro_torch.kernels.tiered_cold.ops import cold_fill


def _np(x) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cold_buffer_words(n_ids: int, meta) -> int:
    """Length (int32 words) of a staged cold buffer that holds all of
    ``n_ids`` ids cold at the widest width: the counts, a position and a
    widest row per id."""
    bits, d = meta["bits"], int(meta["d"])
    widest = max((packing.words_per_row(d, b) for b in bits if b), default=0)
    return len(bits) + n_ids * (1 + widest)


class ColdPrefetch(NamedTuple):
    """The cold-row fill of one id batch, staged by
    ``TieredTableStore.prefetch_cold``: the host gather has happened and
    the copy of the compact buffer to the store's device has been issued.
    Consumed by ``cold_part``/``lookup`` and by the tiered serving cells."""
    n: int                  # flat batch size the fill covers
    buffer: torch.Tensor    # the staged buffer (int32), its used words
    bytes_moved: int        # packed bytes of the cold rows
    counts: tuple           # cold entries per width bucket
    event: object = None    # CUDA event: the copy has landed (None: it has)
    slot: int = -1          # the ColdStaging slot the buffer belongs to

    def wait(self, device):
        """Make the current stream of ``device`` wait for the copy."""
        if self.event is not None:
            torch.cuda.current_stream(device).wait_event(self.event)


class ColdStaging:
    """Double-buffered staging of cold fills for one serving cell on the
    card: two pinned host buffers and two device buffers of ``words``
    int32 each, and a side stream for the copies. Chunk k+1's fill is
    gathered into one slot and copied on the side stream while chunk k's
    replay reads the other slot's copy; a slot is refilled only after the
    copy out of its host buffer ended and the replay stream has taken its
    device buffer (``consumed``)."""

    def __init__(self, words: int, device):
        self.device = torch.device(device)
        self.words = int(words)
        self.host = [torch.empty((self.words,), dtype=torch.int32,
                                 pin_memory=True) for _ in range(2)]
        self.dev = [torch.empty((self.words,), dtype=torch.int32,
                                device=self.device) for _ in range(2)]
        self.stream = torch.cuda.Stream(self.device)
        self._copied = [None, None]    # event: the copy out of host[s] ended
        self._taken = [None, None]     # event: the replay stream took dev[s]
        self._next = 0

    def slot(self) -> tuple:
        """The next slot and its host buffer (numpy), once the last copy
        out of it has ended."""
        s = self._next
        self._next ^= 1
        if self._copied[s] is not None:
            self._copied[s].synchronize()
        return s, self.host[s].numpy()

    def copy(self, s: int, used: int) -> tuple:
        """Issue the copy of slot ``s``'s first ``used`` words to the
        card → (device view, event recorded after it)."""
        with torch.cuda.stream(self.stream):
            if self._taken[s] is not None:
                self.stream.wait_event(self._taken[s])
            dst = self.dev[s][:used]
            dst.copy_(self.host[s][:used], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._copied[s] = event
        return dst, event

    def consumed(self, fill: ColdPrefetch):
        """The current stream has enqueued its last read of ``fill``'s
        device buffer."""
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._taken[fill.slot] = event


class TieredTableStore:
    """Frequency-split hot/cold view of one packed inference table.

    ``table``/``meta`` are the table and static metadata from
    ``build_packed_table`` (tensors on any device, or numpy arrays);
    ``frequencies`` is any per-feature access-count vector (training-log
    counts or the Zipf profile); ``hot_fraction`` pins the top fraction of
    features on the device (0 = everything cold, 1 = everything hot — both
    degenerate tiers stay valid). The hot tier lives on ``device`` (the
    CUDA card unless the caller names another).

    ``row_pad_multiple`` pads hot-subtable rows the way the monolithic table
    pads (a size-aware power of two); the pad rows are the free slots
    promotions land in.
    """

    def __init__(self, table, meta, frequencies, hot_fraction: float, *,
                 row_pad_multiple: int | None = None, device=None):
        self.meta = {"bits": tuple(int(b) for b in meta["bits"]),
                     "d": int(meta["d"]), "n": int(meta["n"])}
        self.hot_fraction = float(hot_fraction)
        self.device = resolve_device(device)
        self._freqs = np.asarray(frequencies)
        bits = self.meta["bits"]

        width_idx = _np(table["width_idx"])
        is_hot = self._hot_mask(width_idx)

        if row_pad_multiple is None:
            n_widths = sum(1 for b in bits if b != 0)
            row_pad_multiple = _auto_pad_multiple(max(int(is_hot.sum()), 1),
                                                  max(n_widths, 1))
        self._row_pad_multiple = int(row_pad_multiple)
        self._policy = None
        self.hot = None
        self.hot_version = 0   # bumped on every write to the hot tier

        self._rebuild(table, is_hot, capacities=None)
        self.reset_counters()

    def _hot_mask(self, width_idx: np.ndarray) -> np.ndarray:
        """Frequency policy for the hot tier: top-``hot_fraction`` features,
        plus every zero-width feature — those never occupy a subtable row
        (their embedding is the zero vector), so hot residency is free."""
        is_hot = hot_feature_mask(self._freqs, self.hot_fraction)
        for i, b in enumerate(self.meta["bits"]):
            if b == 0:
                is_hot[width_idx == i] = True
        return is_hot

    def _rebuild(self, table, is_hot: np.ndarray,
                 capacities: dict | None) -> None:
        """(Re)split ``table`` into the two tiers. ``capacities`` pins each
        hot subtable to an exact row count (the repack path: the device
        tensors are written in place, so their shapes must survive);
        ``None`` pads to ``row_pad_multiple`` and makes the tensors."""
        bits, d, n = self.meta["bits"], self.meta["d"], self.meta["n"]
        width_idx = _np(table["width_idx"]).astype(np.int32)
        local_idx = _np(table["local_idx"]).astype(np.int32)

        tier_local = np.zeros((n,), np.int32)
        hot_subs, mirror, free_slots = {}, {}, {}
        hot_bytes = cold_bytes = mirror_bytes = 0
        for i, b in enumerate(bits):
            if b == 0:
                continue
            sub = _np(table["subtables"][f"b{b}"])              # (rows_p, W)
            feats = np.nonzero(width_idx == i)[0]
            hot_f = feats[is_hot[feats]]
            cold_f = feats[~is_hot[feats]]
            tier_local[hot_f] = np.arange(hot_f.size, dtype=np.int32)
            tier_local[cold_f] = np.arange(cold_f.size, dtype=np.int32)
            # pad hot rows like build_packed_table pads (all-N_b rows)
            n_b, _ = int_bounds(b)
            pad_row = packing.pack_codes(
                torch.full((1, d), n_b, dtype=torch.int32), b).numpy()
            if capacities is not None:
                padded = int(capacities[f"b{b}"])
                if hot_f.size > padded:
                    raise ValueError(
                        f"hot tier b{b} holds {hot_f.size} rows, over its "
                        f"compiled capacity {padded}")
            else:
                padded = _pad_rows(hot_f.size, self._row_pad_multiple)
            hot_rows = np.tile(pad_row, (padded, 1))
            hot_rows[:hot_f.size] = sub[local_idx[hot_f]]
            hot_subs[f"b{b}"] = hot_rows
            # inclusive host mirror: every packed row, indexed by local_idx —
            # the authoritative copy that cold fills, promotions and
            # writebacks all read/write
            mirror[f"b{b}"] = np.array(sub, np.int32)
            # hot pad rows double as free promotion slots; stored descending
            # so pop() hands out the lowest slot first (deterministic)
            free_slots[f"b{b}"] = list(range(padded - 1, hot_f.size - 1, -1))
            hot_bytes += hot_f.size * packing.row_bytes(d, b)
            cold_bytes += cold_f.size * packing.row_bytes(d, b)
            mirror_bytes += mirror[f"b{b}"].nbytes

        # host-side routing vectors (the cold path plans gathers with them)
        self._is_hot_np = is_hot
        self._width_idx_np = width_idx
        self._tier_local_np = tier_local
        self._local_idx_np = local_idx
        self._mirror = mirror
        self._free_slots = free_slots
        self._alpha_np = _np(table["alpha"]).astype(np.float32)
        self._beta_np = _np(table["beta"]).astype(np.float32)

        # the device tier: the reference's hot tree, plus the lookup's
        # width index (-1 at cold features)
        host = {"subtables": hot_subs, "tier_local": tier_local,
                "is_hot": is_hot, "width_idx": width_idx,
                "alpha": self._alpha_np, "beta": self._beta_np,
                "lookup_width_idx": np.where(is_hot, width_idx,
                                             np.int32(-1)).astype(np.int32)}
        if self.hot is None:
            self.hot = _tree_to(host, self.device)
        else:
            _copy_tree_(self.hot, host)
        self._storage = {"hot_bytes": int(hot_bytes),
                         "cold_bytes": int(cold_bytes),
                         "mirror_bytes": int(mirror_bytes)}
        self.hot_version += 1

    # -- serving-time repack (repro_torch.serve.repack) ---------------------

    def refresh(self, table, meta, frequencies=None) -> None:
        """Re-seat a re-packed table into this store *without changing any
        hot-tier tensor's shape or address* — the hook
        ``Engine._swap_now`` uses to keep the captured tiered cells
        valid across a serving-time repack.

        The hot/cold split is recomputed from the (optionally updated)
        frequencies under the same policy as construction, then clamped to
        the hot-subtable capacities: if a repack widened enough hot features
        to overflow a bucket, the coldest overflow features demote to the
        cold tier. Counters stay cumulative; ``storage()`` reflects the new
        split."""
        meta = {"bits": tuple(int(b) for b in meta["bits"]),
                "d": int(meta["d"]), "n": int(meta["n"])}
        if meta != self.meta:
            raise ValueError(
                f"refresh changes the table's static metadata "
                f"({self.meta} -> {meta}) — that is a re-registration, "
                f"not a repack")
        if frequencies is not None:
            self._freqs = np.asarray(frequencies)

        width_idx = _np(table["width_idx"])
        if self._policy is not None:
            # an adaptive policy owns the split: carry the live tier bits
            # across the repack instead of re-seating from training
            # frequencies, and rank overflow demotions by live score
            is_hot = self._is_hot_np.copy()
            for i, b in enumerate(self.meta["bits"]):
                if b == 0:
                    is_hot[width_idx == i] = True
            rank = (self._policy.scores()
                    if hasattr(self._policy, "scores") else self._freqs)
        else:
            is_hot = self._hot_mask(width_idx)
            rank = self._freqs
        caps = {k: int(v.shape[0]) for k, v in self.hot["subtables"].items()}
        for i, b in enumerate(self.meta["bits"]):
            if b == 0:
                continue
            hot_f = np.nonzero(is_hot & (width_idx == i))[0]
            over = hot_f.size - caps[f"b{b}"]
            if over > 0:    # demote the coldest overflow features
                order = hot_f[np.argsort(rank[hot_f], kind="stable")]
                is_hot[order[:over]] = False
        self._rebuild(table, is_hot, capacities=caps)

    # -- incremental tier moves (cache.policy) ------------------------------

    def attach_policy(self, policy):
        """Wire a tier policy (``cache.policy``) into the lookup stream:
        every ``prefetch_cold`` feeds its valid ids to ``policy.observe``,
        so the policy scores exactly the traffic the hit/miss counters see.
        Returns the policy for chaining."""
        self._policy = policy
        return policy

    @property
    def policy(self):
        """The attached tier policy, or ``None`` (static split)."""
        return self._policy

    def free_slot_counts(self) -> dict:
        """Free hot-subtable rows per width key (``{"b8": 3, ...}``) — the
        promotion headroom ``cache.policy`` plans against."""
        return {k: len(v) for k, v in self._free_slots.items()}

    def apply_moves(self, promote, demote) -> dict:
        """Apply one ``TierPlan``'s promotions/demotions *incrementally*, in
        place: no re-pack, no tensor changes shape or address, so the
        captured tiered cells stay valid.

        Demotions flip the tier bit and free the slot — the inclusive
        mirror already holds the row, nothing is copied. Promotions copy
        mirror rows into free slots (one ``index_copy_`` per width). Plans
        must be feasible: every promoted feature cold, every demoted feature
        hot, and per-width promotions ≤ free slots after demotions
        (``DecayAdmissionPolicy.plan`` guarantees this)."""
        promote = np.asarray(promote, np.int64).reshape(-1)
        demote = np.asarray(demote, np.int64).reshape(-1)
        if promote.size == 0 and demote.size == 0:
            return {"promotions": 0, "demotions": 0, "bytes": 0}
        bits, d = self.meta["bits"], self.meta["d"]
        widx = self._width_idx_np
        if promote.size and self._is_hot_np[promote].any():
            raise ValueError("plan promotes features already hot")
        if demote.size and not self._is_hot_np[demote].all():
            raise ValueError("plan demotes features already cold")
        moved = np.concatenate([promote, demote])
        if np.unique(moved).size != moved.size:
            raise ValueError("plan lists a feature twice")
        if any(bits[widx[f]] == 0 for f in moved):
            raise ValueError("zero-width features never occupy a hot row")

        # 1) demote: free the slot, flip the bit — the mirror is authoritative
        for f in demote:
            self._free_slots[f"b{bits[widx[f]]}"].append(
                int(self._tier_local_np[f]))
        self._is_hot_np[demote] = False

        # 2) promote: copy mirror rows into free slots, one copy per width
        nbytes = 0
        slot_idx, slot_val = [], []
        for i, b in enumerate(bits):
            if b == 0:
                continue
            sel = promote[widx[promote] == i]
            if sel.size == 0:
                continue
            free = self._free_slots[f"b{b}"]
            if sel.size > len(free):
                raise ValueError(
                    f"hot tier b{b} has {len(free)} free slots, plan "
                    f"promotes {sel.size}")
            slots = np.asarray([free.pop() for _ in range(sel.size)],
                               np.int32)
            self._tier_local_np[sel] = slots
            rows = self._mirror[f"b{b}"][self._local_idx_np[sel]]
            nbytes += rows.nbytes
            self._write_rows(f"b{b}", slots, rows)
            slot_idx.append(sel)
            slot_val.append(slots)
        self._is_hot_np[promote] = True

        # 3) device routing vectors, at the moved features only
        with torch.no_grad():
            dev = self.device
            idx = torch.from_numpy(moved).to(dev)
            self.hot["is_hot"].index_copy_(
                0, idx, torch.from_numpy(self._is_hot_np[moved]).to(dev))
            self.hot["lookup_width_idx"].index_copy_(0, idx, torch.from_numpy(
                np.where(self._is_hot_np[moved], widx[moved],
                         np.int32(-1)).astype(np.int32)).to(dev))
            if slot_idx:
                self.hot["tier_local"].index_copy_(
                    0, torch.from_numpy(np.concatenate(slot_idx)).to(dev),
                    torch.from_numpy(np.concatenate(slot_val)).to(dev))
        self.hot_version += 1

        # storage accounting stays pad-free, keyed on the tier bit
        for i, b in enumerate(bits):
            if b == 0:
                continue
            delta = (int((widx[promote] == i).sum())
                     - int((widx[demote] == i).sum())) * packing.row_bytes(d, b)
            self._storage["hot_bytes"] += delta
            self._storage["cold_bytes"] -= delta
        self._counters["promotions"] += int(promote.size)
        self._counters["demotions"] += int(demote.size)
        self._counters["promote_bytes"] += int(nbytes)
        return {"promotions": int(promote.size),
                "demotions": int(demote.size), "bytes": int(nbytes)}

    def _write_rows(self, key: str, slots: np.ndarray, rows: np.ndarray):
        """Packed ``rows`` into hot subtable ``key`` at ``slots``, in place."""
        dev = self.device
        with torch.no_grad():
            self.hot["subtables"][key].index_copy_(
                0, torch.from_numpy(slots.astype(np.int64)).to(dev),
                torch.from_numpy(np.ascontiguousarray(rows)).to(dev))

    # -- training-update writeback ------------------------------------------

    def writeback(self, ids, vectors) -> dict:
        """Flow training-time embedding updates into the store without a
        re-pack: re-quantize each vector under its feature's *current*
        width and overwrite the packed row.

        Ordering contract: the host mirror (the cold store) is written
        **first** — it is the authoritative copy — and the hot subtable is
        patched after, only for currently-resident features, so a demotion
        can never lose an update. Duplicate ids resolve last-write-wins.
        Zero-width features store no row and are skipped. The packed words
        are the reference's (the same float32 quantization and packing)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        vectors = np.asarray(vectors, np.float32).reshape(ids.size,
                                                          self.meta["d"])
        if ids.size:
            # np.unique keeps the first occurrence; scan reversed to keep
            # the last (last-write-wins)
            _, first = np.unique(ids[::-1], return_index=True)
            keep = np.sort(ids.size - 1 - first)
            ids, vectors = ids[keep], vectors[keep]
        bits = self.meta["bits"]
        widx = self._width_idx_np[ids] if ids.size else np.zeros(0, np.int32)
        alpha, beta = torch.from_numpy(self._alpha_np), torch.from_numpy(
            self._beta_np)
        nbytes, written, touched_hot = 0, 0, False
        for i, b in enumerate(bits):
            if b == 0:
                continue
            sel = np.nonzero(widx == i)[0]
            if sel.size == 0:
                continue
            f = ids[sel]
            codes = quantize_codes(torch.from_numpy(vectors[sel]), alpha[i],
                                   beta, b)
            words = packing.pack_codes(codes, b).numpy()
            # cold store FIRST: mirror is authoritative (see docstring)
            self._mirror[f"b{b}"][self._local_idx_np[f]] = words
            nbytes += words.nbytes
            written += int(f.size)
            hot_sel = np.nonzero(self._is_hot_np[f])[0]
            if hot_sel.size:
                self._write_rows(f"b{b}", self._tier_local_np[f[hot_sel]],
                                 words[hot_sel])
                nbytes += int(words[hot_sel].nbytes)
                touched_hot = True
        if touched_hot:
            self.hot_version += 1
        self._counters["writebacks"] += written
        self._counters["writeback_bytes"] += int(nbytes)
        return {"written": written, "bytes": int(nbytes)}

    # -- counters -----------------------------------------------------------

    def reset_counters(self):
        self._counters = {"hot_lookups": 0, "cold_lookups": 0,
                          "bytes_moved": 0, "prefetches": 0,
                          "promotions": 0, "demotions": 0,
                          "promote_bytes": 0,
                          "writebacks": 0, "writeback_bytes": 0}

    def counters(self) -> dict:
        """Cumulative tier traffic: ``hot_lookups``/``cold_lookups`` count id
        lookups served per tier, ``bytes_moved`` the packed host→device bytes
        of cold fills, ``hit_rate`` their ratio, plus the static per-tier
        storage bytes. Adaptive-policy activity rides along:
        ``promotions``/``demotions``/``promote_bytes`` from ``apply_moves``
        and ``writebacks``/``writeback_bytes`` from ``writeback``."""
        c = dict(self._counters, **self._storage)
        total = c["hot_lookups"] + c["cold_lookups"]
        c["hit_rate"] = c["hot_lookups"] / total if total else 1.0
        return c

    # -- cold tier (host side) ----------------------------------------------

    def prefetch_cold(self, ids, valid=None, *,
                      staging: ColdStaging | None = None) -> ColdPrefetch:
        """Gather the batch's cold rows on the host and *issue* their copy
        to the store's device. Call it one step (or one chunk) ahead of the
        compute that reads it, in step order: the policy's decayed scores
        depend on the order of the observations.

        ``valid``: optional boolean mask over ``ids`` (or over its leading
        axis — the batcher's per-row validity mask); invalid entries are
        padding: they fetch nothing and stay out of the counters, so hit
        rates and bytes reflect real traffic only.

        The fill is one compact int32 buffer (the layout of
        ``csrc/tiered_cold.cu``): per width bucket its count of cold
        entries, then their flat positions, then their packed words, bucket
        by bucket. With ``staging`` the buffer is gathered into one of its
        pinned slots and copied on its side stream (``fill.event`` marks the
        copy's end); without, it is copied on the current stream.
        ``bytes_moved`` counts the cold rows' packed bytes only."""
        ids = np.asarray(ids)
        flat = ids.reshape(-1)
        if valid is None:
            valid_flat = np.ones(flat.shape, bool)
        else:
            valid = np.asarray(valid, bool)
            if valid.shape != ids.shape:   # per-row mask -> per-id mask
                valid = np.broadcast_to(valid.reshape(valid.shape[0],
                                                      *([1] * (ids.ndim - 1))),
                                        ids.shape)
            valid_flat = valid.reshape(-1)
        if self._policy is not None:
            # the policy sees exactly the traffic the counters see
            self._policy.observe(flat[valid_flat])
        cold = ~self._is_hot_np[flat] & valid_flat
        # only the cold ids are routed further: the same positions, bucket
        # by bucket in ascending order, as routing every id
        pos = np.nonzero(cold)[0]
        cf = flat[pos]
        widx = self._width_idx_np[cf]
        bits, d = self.meta["bits"], self.meta["d"]
        nb = len(bits)
        sels, counts = [], []
        for i, b in enumerate(bits):
            sel = np.nonzero(widx == i)[0] if b else np.zeros(0, np.int64)
            if b and self._mirror[f"b{b}"].shape[0] == 0:
                sel = sel[:0]
            sels.append(sel)
            counts.append(int(sel.size))
        k = sum(counts)
        used = nb + k + sum(c * packing.words_per_row(d, b)
                            for c, b in zip(counts, bits) if b)
        if staging is not None:
            slot, out = staging.slot()
            if used > out.shape[0]:
                raise ValueError(f"a cold fill of {used} words overflows "
                                 f"its staging buffer of {out.shape[0]}")
        else:
            slot, out = -1, np.empty((used,), np.int32)
        out[:nb] = counts
        start, word, nbytes = nb, nb + k, 0
        for i, b in enumerate(bits):
            sel = sels[i]
            if sel.size == 0:
                continue
            out[start:start + sel.size] = pos[sel]
            start += sel.size
            w = packing.words_per_row(d, b)
            rows = out[word:word + sel.size * w].reshape(sel.size, w)
            np.take(self._mirror[f"b{b}"], self._local_idx_np[cf[sel]],
                    axis=0, out=rows)                       # host gather
            word += sel.size * w
            nbytes += rows.nbytes
        event = None
        if staging is not None:
            buffer, event = staging.copy(slot, used)
        else:
            buffer = torch.from_numpy(out).to(self.device)
        self._counters["prefetches"] += 1
        self._counters["hot_lookups"] += int(valid_flat.sum() - cold.sum())
        self._counters["cold_lookups"] += int(cold.sum())
        self._counters["bytes_moved"] += int(nbytes)
        return ColdPrefetch(n=int(flat.size), buffer=buffer,
                            bytes_moved=int(nbytes), counts=tuple(counts),
                            event=event, slot=slot)

    def cold_part(self, fill: ColdPrefetch) -> torch.Tensor:
        """Dequantize a cold fill into a dense ``(n, d)`` float32 tensor
        (zeros where no cold row was staged), by the cold-fill kernel —
        bit-exact against ``packed_lookup``."""
        fill.wait(self.device)
        out = torch.zeros((fill.n, self.meta["d"]), dtype=torch.float32,
                          device=self.device)
        return cold_fill(out, fill.buffer, self.meta, self.hot["alpha"],
                         self.hot["beta"])

    # -- full lookup --------------------------------------------------------

    def lookup(self, ids, fill: ColdPrefetch | None = None) -> torch.Tensor:
        """ids: any int shape -> (*ids.shape, d) float32 on the store's
        device — bit-exact against ``packed_lookup`` on the monolithic
        table. Pass a ``fill`` from an earlier ``prefetch_cold(ids)`` to
        consume an overlapped transfer; otherwise the cold fetch happens
        synchronously here."""
        ids_np = _np(ids)
        if fill is None:
            fill = self.prefetch_cold(ids_np)
        flat = torch.from_numpy(np.ascontiguousarray(
            ids_np.reshape(-1), np.int32)).to(self.device)
        out = tiered_hot_lookup(self.hot, self.meta["bits"], self.meta["d"],
                                flat)                       # 0 at cold ids
        fill.wait(self.device)
        cold_fill(out, fill.buffer, self.meta, self.hot["alpha"],
                  self.hot["beta"])
        return out.reshape(*ids_np.shape, self.meta["d"])

    def storage(self) -> dict:
        """Static per-tier packed bytes (pad-free)."""
        return dict(self._storage)


def _tree_to(tree, device):
    """Nested dicts of numpy arrays → tensors on ``device`` that own their
    memory (never views of the store's host arrays)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return torch.tensor(tree, device=device)


def _copy_tree_(dst: dict, src: dict):
    """Write the numpy tree ``src`` into the tensors of ``dst`` in place,
    on the current stream; shapes must match."""
    for k, v in dst.items():
        if isinstance(v, dict):
            _copy_tree_(v, src[k])
            continue
        s = torch.from_numpy(np.ascontiguousarray(src[k]))
        if tuple(s.shape) != tuple(v.shape) or s.dtype != v.dtype:
            raise ValueError(f"{k}: the rebuilt tier is {tuple(s.shape)} "
                             f"{s.dtype}, the device tensor "
                             f"{tuple(v.shape)} {v.dtype}")
        with torch.no_grad():
            v.copy_(s)


def lookup_view(hot) -> dict:
    """The hot tier as a packed table for ``packed_lookup``: the hot
    subtables, ``local_idx = tier_local``, α, β and a width index that is
    -1 at cold features (their rows come out zero)."""
    return {"subtables": hot["subtables"], "width_idx": hot["lookup_width_idx"],
            "local_idx": hot["tier_local"], "alpha": hot["alpha"],
            "beta": hot["beta"]}


def tiered_hot_lookup(hot, bits, d: int, ids: torch.Tensor) -> torch.Tensor:
    """Device-local gather from a hot tier: ids (any int shape) ->
    (*ids.shape, d) float32, **zeros at cold positions** — one launch of
    the packed lookup over ``lookup_view(hot)``."""
    return packed_lookup(lookup_view(hot), {"bits": tuple(bits), "d": int(d)},
                         ids)


def tiered_hot_lookup_fn(bits, d: int):
    """``tiered_hot_lookup`` with the static metadata bound:
    ``(hot_tree, ids) -> embeddings``."""
    bits = tuple(bits)
    return lambda hot, ids: tiered_hot_lookup(hot, bits, d, ids)
