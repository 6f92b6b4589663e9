"""The port's modes 8/9 on the CPU against the goldens mode9.gaf and
mode8_R10_r2_B05.gaf (``-R 10 -r 2 -B 0.5``).

The comparisons are byte equality of GAF output.
"""

import torch

from recgraph_tpu_torch import cli

from test_torch_rec_pipeline import capture, golden

torch.set_num_threads(1)


def test_golden_mode9_cpu(example_paths):
    got = capture(cli.main, ["-m", "9", *example_paths, "--device", "cpu"])
    assert got == golden("mode9.gaf")


def test_golden_mode8_costs_cpu(example_paths):
    got = capture(cli.main, ["-m", "8", "-R", "10", "-r", "2", "-B", "0.5", *example_paths,
                             "--device", "cpu"])
    assert got == golden("mode8_R10_r2_B05.gaf")
