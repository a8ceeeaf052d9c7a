"""Half of each batch left out: the step's mean is taken over the rest."""


def plant(mp):
    from repro_torch.train.loop import Trainer
    step = Trainer.train_step

    def train_step(self, batch, i):
        n = next(iter(batch.values())).shape[0] // 2
        return step(self, {k: v[:n] for k, v in batch.items()}, i)
    mp.setattr(Trainer, "train_step", train_step)
