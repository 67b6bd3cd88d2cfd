"""Shared dropout masks for the port's parity tests.

The reference draws each dropout mask with `jax.random.bernoulli` from a
concrete key: `F.dropout` outside its op, BERT's attention-probs mask
inside its op body from a key drawn before it (paddle_tpu/models/
bert.py:126, 148), where a VJP retraces the body. `SharedMasks` wraps
`jax.random.bernoulli` so that each (key data, shape, p) returns the
mask it returned first, recorded in draw order, and replaces the port's
`_keep_mask` so that the port's draws take the recorded masks in that
order. Nothing in the JAX package changes; the wrapper and the
replacement live only as long as the test's monkeypatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu_torch.nn.functional import common as t_common


class SharedMasks:
    def __init__(self, monkeypatch):
        self.drawn = []         # the reference's keep masks, in draw order
        self.used = 0           # how many the port has taken
        self._by_key = {}
        orig = jax.random.bernoulli

        def record(key, p=0.5, shape=None, *args, **kwargs):
            with jax.ensure_compile_time_eval():
                tag = (np.asarray(jax.random.key_data(key)).tobytes(),
                       None if shape is None else tuple(shape), float(p))
                if tag not in self._by_key:
                    mask = np.asarray(orig(key, p, shape, *args, **kwargs))
                    self._by_key[tag] = mask
                    self.drawn.append(mask)
                return jnp.asarray(self._by_key[tag])

        monkeypatch.setattr(jax.random, "bernoulli", record)
        monkeypatch.setattr(t_common, "_keep_mask", self._replay)

    def _replay(self, shape, p, generator, device):
        assert self.used < len(self.drawn), "the port drew more masks"
        mask = self.drawn[self.used]
        assert mask.shape == tuple(shape), (mask.shape, tuple(shape))
        self.used += 1
        return torch.from_numpy(mask.copy()).to(device)

    def all_used(self):
        return self.used == len(self.drawn)
