"""Faults planted under the timed path, to show that ``correct`` comes
out false when the port goes wrong. Each is a context manager that
replaces one of the port's entry points while it is active; the drivers
look the entry points up when they set up, so plant before ``setup``.

- ``unchanged``: the train step returns its state as it got it;
- ``half_batch``: the train step runs the first half of the microbatches
  and takes the mean over them;
- ``stale_copy``: the train step updates masters and moments but skips
  ``sync_model``, so the bf16 model the next forward reads keeps the
  weights it had before the step;
- ``wrong_v``: the second moment decays with ``b1`` in place of ``b2``
  (its bias correction with it);
- ``altered_token``: the prefill's last logits put the token the model
  ranks last above all others, so that token is served.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@contextlib.contextmanager
def _replace(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def unchanged():
    from repro_torch.train import step as mod

    def make(orig):
        def make_train_step(arch, cfg, mesh=None):
            inner = orig(arch, cfg, mesh)

            def train_step(state, batch):
                snapshot = {n: p.clone() for n, p in state.params.items()}
                out_state, metrics = inner(state, batch)
                with torch.no_grad():
                    for n, p in out_state.params.items():
                        p.copy_(snapshot[n])
                return out_state, metrics
            return train_step
        return make_train_step
    return _replace(mod, "make_train_step", make)


def half_batch():
    from repro_torch.train import step as mod

    def make(orig):
        def make_train_step(arch, cfg, mesh=None):
            half = cfg.num_microbatches // 2
            inner = orig(arch, dataclasses.replace(cfg, num_microbatches=half), mesh)
            return lambda state, batch: inner(state, {k: v[:half] for k, v in batch.items()})
        return make_train_step
    return _replace(mod, "make_train_step", make)


def stale_copy():
    from repro_torch.train import step as mod

    def make(orig):
        def make_train_step(arch, cfg, mesh=None):
            inner = orig(arch, cfg, mesh)

            def train_step(state, batch):
                with _replace(mod, "sync_model", lambda make_sync: lambda state: None):
                    return inner(state, batch)
            return train_step
        return make_train_step
    return _replace(mod, "make_train_step", make)


def wrong_v():
    from repro_torch.train import step as mod

    def make(orig):
        def apply_optimizer(cfg, params, grads, state):
            return orig(dataclasses.replace(cfg, b2=cfg.b1), params, grads, state)
        return apply_optimizer
    return _replace(mod, "apply_optimizer", make)


def altered_token():
    from repro_torch.serving import serve as mod

    def make(orig):
        def make_prefill_step(model):
            inner = orig(model)

            def prefill(batch):
                logits = inner(batch).clone()
                last = logits[:, -1]
                low = last.argmin(dim=-1, keepdim=True)
                last.scatter_(-1, low, last.max(dim=-1, keepdim=True).values + 1.0)
                return logits
            return prefill
        return make_prefill_step
    return _replace(mod, "make_prefill_step", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "stale_copy": stale_copy,
          "wrong_v": wrong_v, "altered_token": altered_token}
