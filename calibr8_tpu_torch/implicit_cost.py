"""What kernel 1b's team kernel (c8::implicit_team_kernel,
csrc/c8_implicit.cuh) costs: its operations per element, and the
registers and spill bytes that ptxas reports for its instances.
chip_smoke.py and implicit_sweep.py read both.

FLOPS holds, for each instance of implicit_assembly.cu, implicit_eig.cu,
implicit_barlat.cu and implicit_hybrid.cu, (A, B, T): an element whose local Newton takes
`iters` updates and whose line search (FREEZE_PATH models only) needs
`trials` trials in all, up to the accepted one of each update, does A + B
iters + T trials operations, one per add, subtract, multiply, divide,
square root and function call that the function needs: none on a
tangent slot that no seed reaches (a zero by construction, such as the
local state's slots of the polar factors of grad_u, c8_dual.cuh
tangent_zero) or on what such zeros alone make.
tests/test_torch_implicit_team_host.py (the Hosford twins:
tests/test_torch_implicit_eig_host.py; the hybrid:
tests/test_torch_implicit_hybrid_host.py) counts them with
c8::implicit_element on a counting scalar and checks this table.  The
hybrid's row holds for its network HYBRID_NET alone (chip_smoke.py's
decks), which chip_smoke.py checks before it prices a launch.
"""

from __future__ import annotations

import re
import subprocess

import torch

# (A, B, T) operations per element (tests/test_torch_implicit_team_host.py,
# tests/test_torch_implicit_eig_host.py)
FLOPS = {
    "small_hill": (4890, 878, 0),
    "small_hill_plane_strain": (1588, 388, 0),
    "small_hill_plane_stress": (1477, 396, 0),
    "hyper_J2": (10978, 1403, 0),
    "hyper_J2_plane_strain": (2537, 517, 0),
    "hyper_J2_plane_stress": (3715, 997, 0),
    "hypo_hill": (50902, 797, 0),
    "hypo_hill_plane_strain": (8763, 481, 0),
    "hypo_hill_plane_stress": (6590, 495, 0),
    "hypo_barlat": (72663, 11061, 1277),
    "small_hosford": (14011, 5239, 615),
    "hypo_hosford": (60392, 5259, 610),
    "hybrid_hyper_J2_plane_stress": (3813, 1032, 0),
}
# the network the hybrid's row was counted at
HYBRID_NET = {"activation function": "sigmoid", "topology": [1, 4, 1], "input scale": 1.0,
              "output scale": 10.0}
# each instance's model struct (c8_hill.cuh, c8_hyper.cuh, c8_hypo.cuh,
# c8_hosford.cuh, c8_hybrid.cuh), as ptxas names the kernels' instances
MODEL_STRUCT = {"small_hill": "SmallHill", "small_hill_plane_strain": "SmallHillPlaneStrain",
                "small_hill_plane_stress": "SmallHillPlaneStress", "hyper_J2": "HyperJ2",
                "hyper_J2_plane_strain": "HyperJ2PlaneStrain",
                "hyper_J2_plane_stress": "HyperJ2PlaneStress", "hypo_hill": "HypoHill",
                "hypo_hill_plane_strain": "HypoHillPlaneStrain",
                "hypo_hill_plane_stress": "HypoHillPlaneStress", "hypo_barlat": "HypoBarlat",
                "small_hosford": "SmallHosford", "hypo_hosford": "HypoHosford",
                "hybrid_hyper_J2_plane_stress": "HybridHyperJ2PlaneStress"}
# lanes per SM for one float64 or float32 add or multiply a clock (H100)
LANES_PER_SM = {torch.float64: 64, torch.float32: 128}


def team_flops(model: str, hist, trials: int = 0) -> int:
    """Operations of one launch on a model's elements whose local Newton
    counts have the histogram `hist` (hist[i] elements took i updates) and
    whose line searches needed `trials` trials in all."""
    A, B, T = FLOPS[model]
    return sum(n * (A + B * i) for i, n in enumerate(hist)) + T * trials


def sm_max_mhz() -> float:
    """The card's highest SM clock, `nvidia-smi -q -d CLOCK` (Max Clocks)."""
    out = subprocess.run(["nvidia-smi", "-q", "-d", "CLOCK"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    section = None
    for line in out.splitlines():
        if ":" not in line:
            section = line.strip()
        elif section == "Max Clocks" and line.split(":")[0].strip() == "SM":
            return float(line.split(":")[1].split()[0])
    raise RuntimeError(f"no Max Clocks SM line in nvidia-smi -q -d CLOCK:\n{out}")


def nofma_rates() -> dict:
    """{dtype: operations per second} of the card without FMA contraction
    (each add or multiply one operation, on every lane of every SM at the
    highest SM clock): half the FMA peak, a figure beside the bound, not
    the bound."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hz = sm_max_mhz() * 1e6
    return {dt: n * sms * hz for dt, n in LANES_PER_SM.items()}


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_KERNEL = re.compile(r"implicit_(?:team|assembly)_kernelI([df])NS_(\d+)")


def ptxas_usage(log: str) -> dict:
    """{"<dtype> <model>": dict(registers, stack_frame, spill_stores,
    spill_loads)} of the implicit kernel's instances in a library's ptxas
    -v report (the team kernel, or an earlier tree's thread-per-element
    one); bytes, the frame the kernel's own."""
    models = {v: k for k, v in MODEL_STRUCT.items()}
    out, key = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            k = _KERNEL.search(m.group(1))
            key = None
            if k:
                n = int(k.group(2))
                name = m.group(1)[k.end():k.end() + n]
                key = f"{'float64' if k.group(1) == 'd' else 'float32'} {models.get(name, name)}"
                out[key] = {}
            continue
        if key is None:
            continue
        # the entry's own lines come first; a callee's properties (the
        # float64 trig slow path) may follow its register line
        s = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if s and "spill_stores" not in out[key]:
            out[key].update(stack_frame=int(s.group(1)), spill_stores=int(s.group(2)),
                            spill_loads=int(s.group(3)))
        r = re.search(r"Used (\d+) registers", line)
        if r:
            out[key]["registers"] = int(r.group(1))
            key = None
    return out
