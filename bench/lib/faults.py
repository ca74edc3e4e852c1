"""Faults planted in the program under test, to show that the comparison
deciding ``correct`` catches them. Used by ``bench/calibrate.py`` (their
readings at a cell's own size on the card) and by the CPU tests; a
benchmark run never plants one. Each is a context manager that patches
the program while it is open."""
from __future__ import annotations

import contextlib

from bench.lib import program


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def frozen_state():
    """A train step that returns its state unchanged (it still reports the
    loss of its batch)."""
    program._import()
    import torch

    from repro_torch.train import trainer

    def make(model, cfg):
        def step(state, batch):
            with torch.no_grad():
                loss, _ = model.loss(state["params"], batch)
            return state, {"loss": loss}
        return step

    return _patched(trainer, "make_train_step", make)


def half_batch():
    """The loss of every batch taken as the mean over the first half of
    each row's tokens, the rest left out."""
    program._import()
    import torch

    from repro_torch.models.model import Model
    loss = Model.loss

    def half(self, params, batch):
        mask = torch.ones_like(batch["tokens"])
        mask[:, mask.shape[1] // 2:] = 0
        return loss(self, params, dict(batch, loss_mask=mask))

    return _patched(Model, "loss", half)


def altered_token():
    """Every request's third served token altered where the scheduler
    records it (its lowest bit flipped)."""
    program._import()
    from repro_torch.serve import scheduler
    record = scheduler.Request.record

    def alter(self, tok, t=None):
        if len(self.out) == 2:
            tok = int(tok) ^ 1
        return record(self, tok, t)

    return _patched(scheduler.Request, "record", alter)


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch,
          "altered_token": altered_token}
