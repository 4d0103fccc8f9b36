"""The `inverse` CLI's gradient check through a finite-deformation twin:
hyper_J2 (its twin case's constants) on cube n=2, one load step, E, Y and
K active; the port alone on the CPU, ~17 s (27 primal solves), so it sits
in a file of its own."""

import copy

import yaml

from calibr8_tpu_torch.cli.main import main as cli_main
from tests.decks import BCS_3D, CUBE, HYPER_MAT, make_deck


def test_cli_inverse_check_gradient_hyper_J2(tmp_path, capsys):
    deck = copy.deepcopy(make_deck(CUBE, "hyper_J2", HYPER_MAT, BCS_3D(0.01), 1))
    deck["inverse"] = {"materials": {"body": {"E": [800.0, 1200.0], "Y": [8.0, 12.0],
                                              "K": [80.0, 120.0]}},
                       "check gradient": True, "iteration limit": 0}
    path = tmp_path / "hyper_inverse.yaml"
    path.write_text(yaml.safe_dump({"hyper_inverse": deck}))
    assert cli_main(["inverse", str(path), "--device", "cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("gradient check")]
    assert len(line) == 1 and float(line[0].split("=")[1]) > 5.5
