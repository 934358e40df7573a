"""The control: the reference computed in bfloat16 in the program's place
fails the comparison; in float32 it passes."""
import json

import torch

from bench import control, harness


def test_bfloat16_in_the_programs_place_is_caught(bench):
    cell = harness.load_cell(bench, "synth-sample-closed")
    # 8,192-row blocks, where a density needs 13 bits; 400 blocks.  Runs of 512
    # rows: at this size the paper's 2-block runs seldom overlap (no plan parted
    # at 1,000 blocks), so short runs give the near ties the full table has
    cfg = dict(cell.cfg, num_records=8192 * 400 - 100,
               layout_params=dict(cell.cfg["layout_params"], mean_run=512))
    out = control.control(cfg, cell.mix, 5, torch.device("cpu"), n=96)
    assert out["float32"]["plans_off"] == 0
    assert out["bfloat16"]["plans_off"] > 0, json.dumps(out)
