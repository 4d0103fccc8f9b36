"""The feed-forward network of the hybrid constitutive model, in PyTorch.

The port's own copy of calibr8_tpu's models/nn.py FFNN (reference
NN.{hpp,cpp}): a network over a FLAT parameter vector, so that its
weights join the calibrated parameters.  The packing is the reference's
(NN.cpp get_params): per layer, W row-major (out x in), then b.  Hidden
layers take the activation, the output layer is affine.  FFNN holds the
network's description and initial weights; its forward pass over the
elements' lanes is the hybrid twin's _nn_eval (models/batched.py), on
the card csrc/c8_hybrid.cuh.  The initial weights are numpy's
default_rng(seed) draws as calibr8_tpu makes them (uniform on [0, 1),
|W| under positive weights, biases of ones), so the port's initial
parameters equal calibr8_tpu's bit for bit.

The activations are the same formulas as calibr8_tpu's, written so that
their values and torch.func.jvp tangents follow JAX's: sigmoid is
1 / (1 + exp(-x)), softplus is logaddexp(x, 0), relu is maximum(x, 0)
(half the tangent at the tie x = 0, as jnp.maximum gives).

FICNN, the input-convex network, lies on no model's path and is not
ported (ROADMAP queue 1).
"""

from __future__ import annotations

import numpy as np
import torch


def _relu(x):
    return torch.maximum(x, torch.zeros_like(x))


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


ACTIVATIONS = {
    "relu": _relu,
    "sigmoid": _sigmoid,
    "tanh": torch.tanh,
    "softplus": _softplus,
}

# the CUDA kernel's activation codes (csrc/c8_hybrid.cuh)
ACTIVATION_CODE = {"relu": 0, "sigmoid": 1, "tanh": 2, "softplus": 3}


class FFNN:
    """Feed-forward network over a flat parameter vector (calibr8_tpu
    models/nn.py:25-71): topology, activation, initial weights."""

    def __init__(self, activation: str, topology, positive_weights=False, seed=10):
        if len(topology) < 3:
            raise ValueError("FFNN: not enough layers")
        if activation not in ACTIVATIONS:
            raise ValueError(f"FFNN: unknown activation {activation!r}; known: "
                             f"{sorted(ACTIVATIONS)}")
        self.topology = [int(t) for t in topology]
        self.activation = activation
        self.act = ACTIVATIONS[activation]
        self.positive_weights = positive_weights
        self.shapes = [(self.topology[i + 1], self.topology[i])
                       for i in range(len(self.topology) - 1)]
        self.n_params = sum(r * c + r for (r, c) in self.shapes)
        rng = np.random.default_rng(seed)
        parts = []
        for r, c in self.shapes:
            W = rng.random((r, c))
            if positive_weights:
                W = np.abs(W)
            parts.append(W.reshape(-1))
            parts.append(np.ones(r))
        self.init_params = np.concatenate(parts)
