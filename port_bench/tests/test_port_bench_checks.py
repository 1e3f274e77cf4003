"""The check that decides ``correct``, driven on the CPU at a tiny size.

Each cell's sound run passes its limits; the control (the reference in the
precision below the configuration's, in the program's place) fails them; and
a whole run with each fault the cell can have planted underneath the
harness (``port_bench.faults``) comes out with ``correct`` false. The card
check is skipped: the run goes on from set-up, on the CPU, where the port
takes its kernels' plain versions.
"""

import time

import pytest
import torch

from port_bench import faults, harness

CPU = torch.device("cpu")
# Published widths (narrower generators' output barely depends on the mel, and
# their error against the reference is not the published one's); short utterances.
SHORT = {"mean_s": 1.05, "std_s": 0.03, "min_s": 1.0, "max_s": 1.1}
RESIZE = {
    "v1_serve_b1": {"mix": {"utterances": dict(SHORT, count=4), "check_requests": 2}},
    "v2_batch16": {"mix": {"utterances": dict(SHORT, count=8), "batch": 4, "check_batches": 2}},
    "v1_stream_b16": {"mix": {"utterances": dict(SHORT, count=4), "streams": 2,
                              "check_groups": 1}},
    "v1_train_b16": {"h": {"upsample_initial_channel": 32, "mpd_channels": [4, 8, 16, 32],
                           "msd_width": 16}, "mix": {"batch": 2}},
}
FAULTS = {
    "v1_serve_b1": ["alter"],
    "v2_batch16": ["half_batch", "alter"],
    "v1_stream_b16": ["frozen", "alter"],
    "v1_train_b16": ["frozen", "half_batch", "alter"],
}
SEED = 3_000_000_019  # above 32 signed bits, as the driver's seeds are
# long enough for the CPU to finish a checked request, batch or stream group
WINDOW_S = {"v1_stream_b16": 10.0}


def _run(cell: str) -> dict:
    return harness.run_cell(cell, SEED, WINDOW_S.get(cell, 0.3), False, CPU,
                            time.perf_counter(), RESIZE[cell])


def _readings(cell: str, program: str) -> list:
    """Set-up, a short window and the check, as ``calibrate.py`` drives them."""
    entry = harness.cell_entry(harness.benchmark(), cell)
    h = {**harness.config(entry["config"]), **RESIZE[cell].get("h", {})}
    mix = {**harness.mix(entry["traffic"]), **RESIZE[cell].get("mix", {})}
    run = harness.Run(cell, h, mix, SEED, CPU, False, program)
    drv = harness.driver_class(mix)(run)
    drv.window(WINDOW_S.get(cell, 0.3) if mix["driver"] != "train_steps" else 0.0)
    drv.release()
    return drv.check(harness.limits(cell))


@pytest.mark.parametrize("cell", sorted(RESIZE))
def test_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["failed"] == 0 and result["attempted"] > 0
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("cell", sorted(RESIZE))
def test_control_is_not_correct(cell):
    readings = _readings(cell, "control")
    assert readings and not all(r.ok for r in readings), [(r.name, r.value) for r in readings]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS) for f in FAULTS[c]])
def test_fault_is_not_correct(cell, fault):
    assert fault in faults.NAMES
    with faults.planted(fault):
        result = _run(cell)
    assert not result["correct"], (fault, result["checks"])
