"""The port's feed-forward network against calibr8_tpu's, float64 on the
CPU, for two scalar topologies (the hybrid's default [1, 4, 1] and a deep
positive-weight one) and every activation: the initial parameters equal
bit for bit (numpy's default_rng(10) draws, |W| under positive weights),
and the network as the hybrid runs it, the twin's _nn_eval and
_sigma_yield = Y + out_scale (NN(in_scale alpha) - NN(0)) over lanes of
elements with weights of their own, against calibr8_tpu's
HybridHyperJ2PlaneStress (its FFNN's forward pass), values and one
Jacobian-vector product in alpha and the parameter rows together, at
inputs made with numpy from a seed, agree to 1e-14 (the two frameworks'
exp, tanh and log1p may differ in the last bit): the network's of their
max, sigma_yield's of the size of the terms it sums, |Y| + out_scale
(|NN(in_scale alpha)| + |NN(0)|) and its tangent's analog, since the
difference of the two network values cancels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibr8_tpu.models.hybrid import HybridHyperJ2PlaneStress as JaxHybrid
from calibr8_tpu.models.nn import FFNN as JaxFFNN
from calibr8_tpu_torch.models import HybridHyperJ2PlaneStress
from calibr8_tpu_torch.models.batched import get_batched_model
from calibr8_tpu_torch.models.nn import ACTIVATIONS, FFNN

TOPOLOGIES = {"scalar [1, 4, 1]": ([1, 4, 1], False),
              "deep [1, 8, 5, 3, 1] positive": ([1, 8, 5, 3, 1], True)}
LANES = 16


def _close(a, b, scale=None):
    scale = np.abs(np.asarray(b)) if scale is None else scale
    return np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-14 * np.max(scale)


@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_ffnn_matches_jax(topology, activation):
    topo, positive = TOPOLOGIES[topology]
    jnn = JaxFFNN(activation, topo, positive_weights=positive)
    tnn = FFNN(activation, topo, positive_weights=positive)
    assert tnn.n_params == jnn.n_params and tnn.shapes == jnn.shapes
    np.testing.assert_array_equal(tnn.init_params, jnn.init_params)

    cfg = {"embedded model": {"activation function": activation, "topology": topo,
                              "positive weights": positive, "input scale": 0.7,
                              "output scale": 10.0}}
    jm, tm = JaxHybrid(2, cfg), HybridHyperJ2PlaneStress(2, cfg)
    np.testing.assert_array_equal(tm.default_params(), jm.default_params())
    bm = get_batched_model(tm)
    # per lane: E, nu, Y, then the initial weights plus noise
    rng = np.random.default_rng(4)
    P = np.tile(tm.default_params(), (LANES, 1))
    P[:, :3] = [1000.0, 0.25, 10.0]
    P[:, 3:] += 0.5 * rng.standard_normal((LANES, tnn.n_params))
    alpha = rng.uniform(0.05, 1.5, LANES)
    dP, dalpha = rng.standard_normal(P.shape), rng.standard_normal(LANES)
    # float64: importing calibr8_tpu turns x64 on (calibr8_tpu/__init__.py)
    jsy = jax.vmap(jm._sigma_yield)
    yj, tj = jax.jvp(jsy, (jnp.asarray(alpha), jnp.asarray(P)),
                     (jnp.asarray(dalpha), jnp.asarray(dP)))
    assert yj.dtype == jnp.float64
    jnn_lanes = jax.vmap(lambda a, w: jnn(w, jnp.reshape(a, (1,)))[0])
    nj, ntj = jax.jvp(jnn_lanes, (jnp.asarray(alpha), jnp.asarray(P[:, 3:])),
                      (jnp.asarray(dalpha), jnp.asarray(dP[:, 3:])))
    # the terms of sigma_yield: NN(in_scale alpha) and NN(0), with tangents
    terms = [jax.jvp(jnn_lanes, (jnp.asarray(a), jnp.asarray(P[:, 3:])),
                     (jnp.asarray(da), jnp.asarray(dP[:, 3:])))
             for a, da in ((0.7 * alpha, 0.7 * dalpha), (0.0 * alpha, 0.0 * dalpha))]
    y_scale = np.abs(P[:, 2]) + 10.0 * sum(np.abs(np.asarray(v)) for v, _ in terms)
    t_scale = np.abs(dP[:, 2]) + 10.0 * sum(np.abs(np.asarray(t)) for _, t in terms)

    def t_args(a, p):
        return torch.tensor(a), torch.tensor(np.ascontiguousarray(p.T))

    yt, tt = torch.func.jvp(bm._sigma_yield, t_args(alpha, P), t_args(dalpha, dP))
    nt, ntt = torch.func.jvp(bm._nn_eval, t_args(alpha, P), t_args(dalpha, dP))
    assert yt.shape == nt.shape == (LANES,)
    assert _close(yt.numpy(), yj, y_scale) and _close(tt.numpy(), tj, t_scale)
    assert _close(nt.numpy(), nj) and _close(ntt.numpy(), ntj)


def test_relu_splits_the_tangent_at_zero():
    """maximum(x, 0) gives half the tangent at x = 0, as jnp.maximum does."""
    x = torch.tensor([-1.0, 0.0, 2.0], dtype=torch.float64)
    _, t = torch.func.jvp(ACTIVATIONS["relu"], (x,), (torch.ones_like(x),))
    _, tj = jax.jvp(lambda v: jnp.maximum(v, 0.0), (jnp.asarray(x.numpy()),), (jnp.ones(3),))
    np.testing.assert_array_equal(t.numpy(), [0.0, 0.5, 1.0])
    np.testing.assert_array_equal(t.numpy(), np.asarray(tj))
