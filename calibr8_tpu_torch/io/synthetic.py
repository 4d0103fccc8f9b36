"""Synthetic DIC data and field persistence.

The counterpart of calibr8_tpu's io/synthetic.py (reference
synthetic.{hpp,cpp}, main_primal.cpp:240-242): the primal's per-step
displacements become nodal fields `measured_<step>` on the mesh
(Mesh.fields, numpy on the host), which the calibration QoI reads.  They
persist as a compressed .npz, the same file either package writes and
reads.
"""

from __future__ import annotations

import numpy as np


def attach_synthetic(mesh, disc, traj) -> None:
    """Store the trajectory's displacements as measured_<step> nodal
    fields (n_nodes, dim) on the mesh, steps 0..N."""
    for step, x in enumerate(traj.x):
        u = x[: disc.n_dofs_u].reshape(disc.n_nodes, disc.spec.dim)
        mesh.fields[f"measured_{step}"] = u.detach().cpu().numpy().copy()


def save_fields(mesh, path) -> None:
    np.savez_compressed(path, **mesh.fields)


def load_fields(mesh, path) -> None:
    with np.load(path) as data:
        for k in data.files:
            mesh.fields[k] = data[k]


def perturb_fields(fields: dict, sigma: float, seed: int = 0, prefix="measured_") -> None:
    """Add seeded Gaussian noise, in place, to every field named
    <prefix><step> but step 0, in the dict's order: numpy's
    default_rng(seed) draws, one standard_normal per field."""
    rng = np.random.default_rng(seed)
    for k in list(fields):
        if k.startswith(prefix) and not k.endswith("_0"):
            fields[k] = fields[k] + sigma * rng.standard_normal(fields[k].shape)


def perturb_measured(mesh, sigma: float, seed: int = 0, prefix="measured_") -> None:
    """Noisy measured fields, the analog of the reference's `perturber`
    (perturber.cpp:20-50): the same draws in the same field order as
    calibr8_tpu's perturb_measured."""
    perturb_fields(mesh.fields, sigma, seed, prefix)
