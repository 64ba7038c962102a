"""Shared checks of the port's train step against the reference's, used by
``tests/test_torch_train_transformers.py`` and
``tests/test_torch_train_recurrent.py`` (split in two so that each file
stays short on one test worker).

Both packages start from the reference's ``init_params`` (fixed key),
carried across with ``load_reference_params``, and take the same
``make_batch`` arrays.  Everything is float32; the packages differ in the
order of additions only (~1e-6 relative per op), so:

* loss, ``aux_loss`` and ``grad_norm`` agree within rtol 1e-5;
* every leaf's gradient agrees within 1e-4 of the leaf's largest entry;
* after one AdamW step (lr 1e-3) the parameters agree within rtol 1e-5,
  atol 1e-6 where the step is insensitive to that gradient noise.  The
  first step is u = g / (|g| + eps) (clipped g, eps 1e-8), so a gradient
  off by dg moves the parameter by lr eps dg / g^2: an entry is held tight
  where |g| is over 10 x the noise (dg = 1e-4 x the leaf's max) and lr
  eps dg / g^2 is under half the atol.  Elsewhere the step is ~lr sign(g)
  and a gradient within the noise may take either sign in either package,
  so those entries are held within 2 lr.  (g comes from the reference's
  first moment, m = (1 - b1) g.)
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.data import make_batch as r_make_batch
from repro.models import layers as r_layers
from repro.models import model as r_model
from repro.optim import AdamW as RAdamW
from repro_torch import tree as tree_lib
from repro_torch.configs import get_smoke
from repro_torch.data import make_batch
from repro_torch.models import model as p_model
from repro_torch.optim import AdamW

B, S, LR = 4, 32, 1e-3
B1, EPS = 0.9, 1e-8       # AdamW's defaults in both packages
METRIC_RTOL = 1e-5
GRAD_REL = 1e-4          # of the leaf's largest entry
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6


@functools.lru_cache(maxsize=None)
def setup(arch: str):
    """Both configs, the reference's parameters (a jax tree) and the numpy
    tree they came from (no test writes to either)."""
    rcfg, pcfg = r_get_smoke(arch), get_smoke(arch)
    rparams = jax.jit(r_model.get_model(rcfg).init_params)(
        jax.random.PRNGKey(0))
    return rcfg, pcfg, rparams, jax.tree.map(np.asarray, rparams)


def port_params(arch: str) -> dict:
    """A fresh copy of the port's parameters (the port's AdamW writes them
    in place)."""
    _, pcfg, _, tree = setup(arch)
    return p_model.load_reference_params(pcfg, tree, "cpu")


def batch(arch: str, accum: int = 1, step: int = 0) -> dict:
    rcfg, pcfg, _, _ = setup(arch)
    out = make_batch(pcfg, B, S, step, seed=0, accum=accum)
    want = r_make_batch(rcfg, B, S, step, seed=0, accum=accum)
    assert sorted(out) == sorted(want)
    for key in out:
        np.testing.assert_array_equal(out[key], want[key], err_msg=key)
    return out


def reference_step(arch: str, accum: int = 1, pod_compress: bool = False,
                   npod: int = 1):
    rcfg, _, rparams, _ = setup(arch)
    opt = RAdamW(lr=LR)
    state = opt.init(rparams)
    if pod_compress:
        state["ef_error"] = r_model.init_ef_error(rparams, npod)
    step = jax.jit(r_model.make_train_step(
        rcfg, opt, accum=accum, pod_compress=pod_compress, npod=npod))
    b = {k: jnp.asarray(v) for k, v in batch(arch, accum).items()}
    params, state, metrics = step(rparams, state, b)
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state),
            {k: float(v) for k, v in metrics.items()})


def reference_grads(arch: str):
    """The reference's gradient of its total loss on microbatch 0."""
    rcfg, _, rparams, _ = setup(arch)
    model = r_model.get_model(rcfg)

    def loss(p, b):
        return r_model._loss_fn(rcfg, model, p, b, r_layers.no_shard)

    b = {k: jnp.asarray(v[0]) for k, v in batch(arch).items()}
    (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        rparams, b)
    return jax.tree.map(np.asarray, grads)


def port_step(arch: str, accum: int = 1, pod_compress: bool = False,
              npod: int = 1):
    _, pcfg, _, _ = setup(arch)
    params = port_params(arch)
    opt = AdamW(lr=LR)
    state = opt.init(params)
    if pod_compress:
        state["ef_error"] = p_model.init_ef_error(params, npod)
    step = p_model.make_train_step(pcfg, opt, accum=accum,
                                   pod_compress=pod_compress, npod=npod,
                                   device="cpu")
    params, state, metrics = step(params, state, batch(arch, accum))
    return params, state, {k: float(v) for k, v in metrics.items()}


def port_grads(arch: str) -> list[torch.Tensor]:
    _, pcfg, _, _ = setup(arch)
    params = port_params(arch)
    mb = p_model._device_batch({k: v[0] for k, v in batch(arch).items()},
                               torch.device("cpu"))
    _, grads = p_model._grads(pcfg, p_model.get_model(pcfg, "cpu"), params,
                              mb)
    return grads


def check_metrics(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want) == ["aux_loss", "grad_norm", "loss"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=key)


def check_grads(got: list, want_tree) -> None:
    """Every leaf within GRAD_REL of its largest entry, and non-zero where
    the reference's is."""
    want = tree_lib.leaves(want_tree)
    names = tree_lib.paths(want_tree)
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, np.float32)
        g = g.detach().numpy()
        scale = float(np.abs(w).max())
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * scale
                                   + 1e-30, err_msg=name)
        assert (float(np.abs(g).max()) > 0) == (scale > 0), name


def check_params(got_tree, want_tree, m_tree, noise_rel=GRAD_REL) -> None:
    """The updated parameters, under the AdamW first-step rule of the module
    docstring, ``m_tree`` the reference's first moment after the step and
    ``noise_rel`` the gradient's noise as a share of the leaf's max."""
    for name, g, w, gr in zip(tree_lib.paths(want_tree),
                              tree_lib.leaves(got_tree),
                              tree_lib.leaves(want_tree),
                              tree_lib.leaves(m_tree)):
        g = g.detach().numpy()
        w = np.asarray(w, np.float32)
        gr = np.abs(np.asarray(gr, np.float64)) / (1 - B1)
        noise = noise_rel * max(float(gr.max()), 1e-30)
        with np.errstate(divide="ignore"):
            sure = (gr > 10 * noise) & (LR * EPS * noise / gr ** 2
                                        < PARAM_ATOL / 2)
        np.testing.assert_allclose(g[sure], w[sure], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=name)
        assert float(np.abs(g - w).max(initial=0.0)) <= 2 * LR * (1 + 1e-3), \
            name


# int8 compression: an entry of (g + e) / scale that the two packages round
# to two neighbouring integers moves the pod's mean by one step, scale =
# amax / 127, and its error-feedback entry by the same step (about twice the
# largest error, scale / 2): the noise of the compressed gradient
POD_NOISE_REL = 1 / 127


def check_ef_error(got_tree, want_tree) -> None:
    """The bf16 error-feedback buffers [npod, ...] of the two packages: each
    entry within one quantisation step (2.5 x the largest error: see
    POD_NOISE_REL), and under 1% of the entries off by more than bf16's
    rounding (2^-7 of the largest)."""
    for name, g, w in zip(tree_lib.paths(want_tree),
                          tree_lib.leaves(got_tree),
                          tree_lib.leaves(want_tree)):
        g = g.float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        top = float(np.abs(w).max(initial=0.0))
        err = np.abs(g - w)
        assert float(err.max(initial=0.0)) <= 2.5 * top + 1e-30, name
        assert np.mean(err > 2.0 ** -7 * top) < 0.01, name
