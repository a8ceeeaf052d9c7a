"""The table alone left unchanged by each step (Adam skipping its largest
leaf): every other leaf moves as it should."""
import torch


def plant(mp):
    from perfbench.models.common import named
    from repro_torch.train.loop import Trainer
    step = Trainer.train_step

    def train_step(self, batch, i):
        table = max(named(self.params).values(), key=torch.numel)
        before = table.detach().clone()
        out = step(self, batch, i)
        with torch.no_grad():
            table.copy_(before)
        return out
    mp.setattr(Trainer, "train_step", train_step)
