"""The two heavier goldens of the hypo_hill family through the port alone
on the CPU (tests/decks.py), each at its tolerance of 1e-8:
notch2D_hypo_J2_plane_stress (4 steps, displacement only, ~12 s) through
Problem, and notch_hypo_J2 (notch3D, 4 steps, mixed u/p, ~26 s) through
the `primal` CLI, whose `regression` block must print PASS.  The plane
strain golden is in test_torch_primal.py; these two sit in a file of two
tests, which xdist's loadfile queue runs beside
tests/test_dist_pallas.py."""

import copy
import os
import subprocess
import sys
from pathlib import Path

import yaml

from tests.decks import PRIMAL_REGRESSIONS
from tests.test_torch_primal import check_golden

ROOT = Path(__file__).resolve().parents[1]


def test_hypo_plane_stress_golden():
    check_golden(*PRIMAL_REGRESSIONS["notch2D_hypo_J2_plane_stress"][:3])


def test_cli_primal_hypo_golden_prints_pass(tmp_path):
    deck, gold, tol, _ = PRIMAL_REGRESSIONS["notch_hypo_J2"]
    deck = copy.deepcopy(deck)
    deck["regression"] = {"QoI": gold, "relative error tol": tol}
    path = tmp_path / "notch_hypo_J2.yaml"
    path.write_text(yaml.safe_dump({"notch_hypo_J2": deck}))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-m", "calibr8_tpu_torch", "primal", str(path), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert " PASS" in r.stdout, r.stdout
