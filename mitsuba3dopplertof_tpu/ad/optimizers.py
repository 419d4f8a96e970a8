"""Gradient-based optimizers over scene parameters
(reference src/python/python/ad/optimizers.py).

Difference: there is no in-place autodiff tape — gradients come
out of ``jax.grad`` / ``mi.ad.render_grad`` as a dict, so ``step(grads)``
takes them explicitly instead of reading ``.grad`` off the variables.
Everything else matches the reference surface: dict-like access over the
optimized variables, per-key learning rates, ``reset``, SGD momentum with
``mask_updates``, and Adam with ``mask_updates`` and the UniformAdam
variant [Nicolet et al. 2021].

Usage::

    params = mi.traverse(scene)
    opt = mi.ad.Adam(lr=0.05, params={k: params[k] for k in keys})
    for it in range(n):
        grads = ...                      # jax.grad of the image loss
        opt.step(grads)
        params.update(opt)
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _to_array(value):
    return jnp.asarray(value, jnp.float32)


class Optimizer:
    """Base class of all gradient-based optimizers (dict-like over the
    optimized variables; reference optimizers.py Optimizer)."""

    def __init__(self, lr, params: dict = None):
        self.lr_default = None
        self.lr = {}
        self.set_learning_rate(lr)
        self.variables = {}
        self.state = {}
        if params:
            for k, v in params.items():
                self[k] = v

    # -- mapping protocol ------------------------------------------------
    def __contains__(self, key: str):
        return key in self.variables

    def __getitem__(self, key: str):
        return self.variables[key]

    def __setitem__(self, key: str, value):
        needs_reset = (key not in self.variables
                       or np.shape(self.variables[key])
                       != np.shape(_to_array(value)))
        self.variables[key] = _to_array(value)
        if needs_reset:
            self.reset(key)

    def __delitem__(self, key: str) -> None:
        del self.variables[key]
        self.state.pop(key, None)
        self.lr.pop(key, None)

    def __len__(self) -> int:
        return len(self.variables)

    def __iter__(self):
        return iter(self.variables)

    def keys(self):
        return self.variables.keys()

    def items(self):
        return self.variables.items()

    def set_learning_rate(self, lr) -> None:
        """Set the learning rate: a scalar (the default for every key) or a
        ``dict`` of per-key rates (reference optimizers.py:83)."""
        if isinstance(lr, (int, float)):
            self.lr_default = float(lr)
        elif isinstance(lr, dict):
            for k, v in lr.items():
                self.lr[k] = float(v)
        else:
            raise TypeError("set_learning_rate: expected a scalar or dict")

    def _lr(self, key):
        return self.lr.get(key, self.lr_default)

    def reset(self, key):
        raise NotImplementedError

    def step(self, grads: dict):
        raise NotImplementedError

    def _iter_grads(self, grads):
        for k, g in grads.items():
            if k not in self.variables or g is None:
                continue
            g = _to_array(g)
            p = self.variables[k]
            if g.shape != p.shape:
                raise RuntimeError(
                    f"Optimizer.step(): gradient shape {g.shape} does not "
                    f"match variable '{k}' shape {p.shape}")
            yield k, p, g


class SGD(Optimizer):
    """Stochastic gradient descent with optional momentum (reference
    optimizers.py SGD: v = momentum*v + g; p -= lr * v)."""

    def __init__(self, lr, momentum=0.0, mask_updates=False,
                 params: dict = None):
        assert 0.0 <= momentum < 1.0 and lr > 0
        self.momentum = float(momentum)
        self.mask_updates = bool(mask_updates)
        super().__init__(lr, params)

    def step(self, grads: dict):
        for k, p, g in self._iter_grads(grads):
            lr = self._lr(k)
            if self.momentum != 0.0:
                v_prev = self.state[k]
                v = self.momentum * v_prev + g
                if self.mask_updates:
                    nonzero = g != 0.0
                    v = jnp.where(nonzero, v, v_prev)
                self.state[k] = v
                step = lr * v
            else:
                step = lr * g
            self.variables[k] = p - step

    def reset(self, key):
        """Zero-initialize the momentum state for ``key``."""
        if self.momentum != 0.0:
            self.state[key] = jnp.zeros_like(self.variables[key])
        else:
            self.state[key] = None

    def __repr__(self):
        return (f"SGD[\n  variables = {list(self.keys())},\n"
                f"  lr = {dict(self.lr, default=self.lr_default)},\n"
                f"  momentum = {self.momentum:g}\n]")


class Adam(Optimizer):
    """Adam [Kingma and Ba 2015] with the reference's ``mask_updates``
    (sparse-Adam behavior for unobserved parameters) and ``uniform``
    (UniformAdam: the max of the second-moment estimates replaces the
    per-element ones; reference optimizers.py Adam.step)."""

    def __init__(self, lr, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                 mask_updates=False, uniform=False, params: dict = None):
        assert 0 <= beta_1 < 1 and 0 <= beta_2 < 1 and lr > 0 and epsilon > 0
        self.beta_1 = float(beta_1)
        self.beta_2 = float(beta_2)
        self.epsilon = float(epsilon)
        self.mask_updates = bool(mask_updates)
        self.uniform = bool(uniform)
        self.t = {}
        super().__init__(lr, params)

    def step(self, grads: dict):
        for k, p, g in self._iter_grads(grads):
            self.t[k] = self.t.get(k, 0) + 1
            lr_scale = (np.sqrt(1.0 - self.beta_2 ** self.t[k])
                        / (1.0 - self.beta_1 ** self.t[k]))
            lr_t = self._lr(k) * lr_scale
            m_tp, v_tp = self.state[k]
            m_t = self.beta_1 * m_tp + (1.0 - self.beta_1) * g
            v_t = self.beta_2 * v_tp + (1.0 - self.beta_2) * (g * g)
            if self.mask_updates:
                nonzero = g != 0.0
                m_t = jnp.where(nonzero, m_t, m_tp)
                v_t = jnp.where(nonzero, v_t, v_tp)
            self.state[k] = (m_t, v_t)
            if self.uniform:
                denom = jnp.sqrt(jnp.max(v_t)) + self.epsilon
            else:
                denom = jnp.sqrt(v_t) + self.epsilon
            step = lr_t * m_t / denom
            if self.mask_updates:
                step = jnp.where(nonzero, step, 0.0)
            self.variables[k] = p - step

    def reset(self, key):
        """Zero-initialize the moment state for ``key``."""
        z = jnp.zeros_like(self.variables[key])
        self.state[key] = (z, z)
        self.t[key] = 0

    def __repr__(self):
        return (f"Adam[\n  variables = {list(self.keys())},\n"
                f"  lr = {dict(self.lr, default=self.lr_default)},\n"
                f"  betas = ({self.beta_1:g}, {self.beta_2:g}),\n"
                f"  eps = {self.epsilon:g}\n]")


__all__ = ["Optimizer", "SGD", "Adam"]
