"""YAML input-deck parsing.

Keeps the reference deck schema (Teuchos YAML ParameterList, one deck
per run — reference: source/calibr8/src/main_primal.cpp:20-31,
test/primal/*.yaml.in): a single root key wrapping the sublists

  problem, discretization, residuals (global residual / local residual
  with per-element-set materials), dirichlet bcs, traction bcs,
  quantity of interest, regression, linear algebra, inverse,
  virtual fields, adaptivity

so reference decks parse unmodified.  Extensions: the `discretization`
sublist accepts `builtin mesh: {type: cube|square|notch2D|notch3D, ...}`
to use the built-in generators.  This is calibr8_tpu's deck schema and
validation, unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np


def load_deck(path_or_dict, subs: dict | None = None) -> "ProblemSpec":
    """Parse a deck.  `subs` substitutes `@VAR@` placeholders in the
    raw text before parsing — the CMake configure_file step the
    reference applies to its `*.yaml.in` test decks (e.g.
    `@CMAKE_SOURCE_DIR@` -> source tree root), so the reference's own
    deck files load unmodified.  `CALIBR8_CMAKE_SOURCE_DIR` in the
    environment provides a default for `@CMAKE_SOURCE_DIR@`."""
    if isinstance(path_or_dict, dict):
        raw = path_or_dict
    else:
        with open(path_or_dict) as f:
            text = f.read()
        import os

        all_subs = {}
        if "@CMAKE_SOURCE_DIR@" in text:
            # default: infer the source root from an in-tree deck path
            # (…/<root>/test/<suite>/deck.yaml.in -> <root>), exactly
            # what CMake's configure_file would have produced; the env
            # var and explicit `subs` both override.
            p = os.path.abspath(str(path_or_dict))
            if f"{os.sep}test{os.sep}" in p:
                all_subs["CMAKE_SOURCE_DIR"] = p.rsplit(
                    f"{os.sep}test{os.sep}", 1
                )[0]
        if "@CMAKE_BINARY_DIR@" in text:
            # build-dir paths (reference: test/{python,femu}/*.yaml.in
            # write load.dat and the synthetic mesh under
            # ${CMAKE_BINARY_DIR}/test/<suite>/): ctest runs those
            # decks with cwd = build/test/<suite>, so the run cwd
            # plays that role — chained decks run from one cwd agree
            # on the same artifact paths.  For an in-tree deck the
            # whole `@CMAKE_BINARY_DIR@/test/<suite>` prefix collapses
            # to cwd.
            p = os.path.abspath(str(path_or_dict))
            if f"{os.sep}test{os.sep}" in p and not os.environ.get(
                "CALIBR8_CMAKE_BINARY_DIR"
            ):
                suite = os.path.basename(os.path.dirname(p))
                text = text.replace(
                    f"@CMAKE_BINARY_DIR@/test/{suite}", os.getcwd()
                )
            all_subs["CMAKE_BINARY_DIR"] = os.getcwd()
        for var in ("CMAKE_SOURCE_DIR", "CMAKE_BINARY_DIR"):
            if os.environ.get(f"CALIBR8_{var}"):
                all_subs[var] = os.environ[f"CALIBR8_{var}"]
        all_subs.update(subs or {})
        for key, val in all_subs.items():
            text = text.replace(f"@{key}@", str(val))
        # PyYAML is needed only to read deck files: decks given as dicts
        # (chip_smoke.py, the tests) load without it
        import yaml

        raw = yaml.safe_load(text)
    # unwrap the single problem-name root key if present
    if len(raw) == 1 and not (set(raw) & _VALID_ROOT_KEYS):
        raw = next(iter(raw.values()))
    _validate_root(raw)
    return ProblemSpec(raw)


# the valid top-level sublists — the reference validates each driver's
# deck against an allowed sublist set and FAILS FAST on anything else
# (source/calibr8/src/main_primal.cpp:20-31 get_valid_params +
# validateParameters); a typo'd sublist must not be silently ignored.
_VALID_ROOT_KEYS = {
    "problem",
    "problems",  # multi-problem inverse decks (test/adjoint/2prob)
    "discretization",
    "residuals",
    "dirichlet bcs",
    "traction bcs",
    "quantity of interest",
    "quantities of interest",  # multi-QoI extension
    "regression",
    "linear algebra",
    "inverse",
    "virtual fields",
    "objective",
    "adaptivity",
    # unit decks carry the residual sublists at the root
    # (test/unit/unit.yaml.in)
    "local residual",
    "global residual",
}

# source/calibr8/src/small_J2.cpp:11-19 get_valid_local_residual_params
_VALID_LOCAL_RESIDUAL_KEYS = {
    "type",
    "nonlinear max iters",
    "nonlinear absolute tol",
    "nonlinear relative tol",
    "materials",
    "line search",  # local-Newton line search (test/primal/notch_hypo_barlat)
    "embedded model",  # hybrid NN models
}


def _validate_root(raw):
    if not isinstance(raw, dict):
        raise ValueError(f"deck root must be a mapping, got {type(raw)}")
    unknown = set(raw) - _VALID_ROOT_KEYS
    if unknown:
        raise ValueError(
            f"unknown deck sublist(s) {sorted(unknown)}; valid sublists: "
            f"{sorted(_VALID_ROOT_KEYS)}"
        )
    lr = (raw.get("residuals") or {}).get("local residual") or raw.get(
        "local residual"
    )
    if isinstance(lr, dict):
        bad = set(lr) - _VALID_LOCAL_RESIDUAL_KEYS
        if bad:
            raise ValueError(
                f"unknown 'local residual' key(s) {sorted(bad)}; valid: "
                f"{sorted(_VALID_LOCAL_RESIDUAL_KEYS)}"
            )


@dataclass
class ProblemSpec:
    data: dict[str, Any]

    def sub(self, name: str, default=None) -> dict:
        v = self.data.get(name, default if default is not None else {})
        return v or {}

    # -- discretization -----------------------------------------------
    @property
    def disc(self) -> dict:
        return self.sub("discretization")

    @property
    def num_steps(self) -> int:
        return int(self.disc.get("num steps", 1))

    @property
    def step_size(self) -> float:
        return float(self.disc.get("step size", 1.0))

    # -- residuals ----------------------------------------------------
    @property
    def global_residual(self) -> dict:
        return self.sub("residuals").get("global residual", {})

    @property
    def local_residual(self) -> dict:
        return self.sub("residuals").get("local residual", {})

    @property
    def model_name(self) -> str:
        return self.local_residual["type"]

    def materials(
        self, param_names, allow_missing: bool = False
    ) -> tuple[list[str], np.ndarray]:
        """Per-elem-set parameter matrix in model order, VALIDATED
        against the model's parameter list: the reference rejects
        unknown material keys (validateParameters against
        get_valid_material_params, source/calibr8/src/small_J2.cpp:20-29)
        and throws on missing ones (Teuchos get<double> without a
        default, small_J2.cpp:55-64) — a typo'd 'Yy' must fail here
        with the key named, not deep in tracing.

        `allow_missing=True` permits absent parameters (models with
        default_params — embedded-NN weights are not deck keys)."""
        mats = self.local_residual.get("materials", {})
        names = list(mats.keys())
        valid = set(param_names)
        vals = np.zeros((len(names), len(param_names)))
        for i, es in enumerate(names):
            m = mats[es] or {}
            unknown = set(m) - valid
            if unknown:
                raise ValueError(
                    f"unknown material parameter(s) {sorted(unknown)} for "
                    f"element set {es!r}; this model's parameters: "
                    f"{list(param_names)}"
                )
            if not allow_missing:
                missing = valid - set(m)
                if missing:
                    raise ValueError(
                        f"missing material parameter(s) {sorted(missing)} "
                        f"for element set {es!r}; this model requires: "
                        f"{list(param_names)}"
                    )
            for j, pname in enumerate(param_names):
                vals[i, j] = float(m.get(pname, 0.0))
        return names, vals

    # -- bcs ----------------------------------------------------------
    @property
    def dirichlet_expression(self) -> list:
        """[(resid_idx, eq, node_set, expr), ...]"""
        out = []
        sub = self.sub("dirichlet bcs").get("expression", {})
        for _, entry in sub.items():
            out.append(
                (int(entry[0]), int(entry[1]), str(entry[2]), str(entry[3]))
            )
        return out

    @property
    def dirichlet_field(self) -> list:
        """Field-based (measured-data) DBCs: [(i, eq, node_set, field), ...]
        (reference: dbcs.hpp:23-60)."""
        out = []
        sub = self.sub("dirichlet bcs").get("field", {})
        for _, entry in sub.items():
            out.append(
                (int(entry[0]), int(entry[1]), str(entry[2]), str(entry[3]))
            )
        return out

    @property
    def tractions(self) -> list:
        out = []
        for _, entry in self.sub("traction bcs").items():
            idx = int(entry[0])
            side_set = str(entry[1])
            vals = tuple(str(v) for v in entry[2:])
            out.append((idx, side_set, vals))
        return out

    # -- qoi / regression ---------------------------------------------
    @property
    def qoi(self) -> dict:
        return self.sub("quantity of interest")

    @property
    def regression(self) -> dict:
        return self.sub("regression")

    # -- linear algebra ------------------------------------------------
    @property
    def linear_algebra(self) -> dict:
        """Understands both the native simplified block
        {method, tolerance, maximum iterations} and the reference's
        Stratimikos tree (Belos Block GMRES settings are extracted)."""
        la = self.sub("linear algebra")
        out = {
            "method": "auto",
            "tolerance": 1e-6,
            "maximum iterations": 200,
            "preconditioner": "block_gs",
        }
        if not la:
            return out
        if "method" in la:
            out["method"] = la["method"]
        if "preconditioner" in la:
            out["preconditioner"] = la["preconditioner"]
        if "preconditioner reuse" in la:
            out["preconditioner reuse"] = str(la["preconditioner reuse"])
        if "tolerance" in la:
            out["tolerance"] = float(la["tolerance"])
        if "maximum iterations" in la:
            out["maximum iterations"] = int(la["maximum iterations"])
        try:
            gm = la["Linear Solver Types"]["Belos"]["Solver Types"]["Block GMRES"]
            out["tolerance"] = float(gm.get("Convergence Tolerance", 1e-6))
            out["maximum iterations"] = int(gm.get("Maximum Iterations", 200))
        except (KeyError, TypeError):
            pass
        return out

    @property
    def inverse(self) -> dict:
        return self.sub("inverse")

    @property
    def problem_name(self) -> str:
        return self.sub("problem").get("name", "problem")
