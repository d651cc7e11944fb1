"""The control on the card: the reference put in the program's place and
computed in TF32, the next precision below the configurations' float32,
comes out not correct under each cell's limits, where the program comes
out correct.  At the cells' own sizes, where the limits were set
(``tools/calibrate.py`` reads the same over more seeds): at a smaller
batch the program's later steps read higher, and the cells' limits do
not hold there."""
from __future__ import annotations

import pytest
import torch

from port_bench.lib import spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["features_train", "attention_train", "features_serve"])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_tf32_control_is_not_correct(cuda_device, workload, seed):
    cell = spec.Cell(workload)
    d = cell.driver_class()(cell.config, cell.traffic, seed, cuda_device)
    d.setup()
    if d.kind == "serve":
        d.window(3.0)
    d.release()
    if d.kind == "train":
        want = d.reference_run("f32")
        program = d.readings(d.checked, want)
        control = d.readings(d.reference_run("tf32"), want)
    else:
        program = d.readings(lambda r, _: torch.from_numpy(d.served[r][1]).to(cuda_device))
        control = d.readings(lambda r, _: d.reference_logits(d.served[r][0], tf32=True)
                             .argmax(dim=1))
    assert all(program[k] <= v for k, v in cell.limits.items()), program
    assert any(control[k] > v for k, v in cell.limits.items()), control
