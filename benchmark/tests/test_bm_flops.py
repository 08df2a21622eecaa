"""The operation counts the harness reads: each configuration's
``flops_per_window`` is what ``torch.utils.flop_counter`` counts on the
frozen reference at published widths, plus the LSTMs it does not count."""

import pytest

from conftest import REPO
from benchmark import bounds, manifest, reference

MAN = manifest.load(REPO)


@pytest.mark.parametrize("name,published", [("eqtransformer", 2.57e8), ("phasenet", 3.89e7)])
def test_flops_per_window_matches_the_counter(name, published):
    cfg = manifest.config(MAN, name, REPO)
    model = reference.build_model(cfg, "cpu")
    a = cfg["model_args"]
    counted = bounds.flops_per_window(model, a["in_channels"], a["in_samples"])
    assert counted == cfg["flops_per_window"]
    assert abs(counted / published - 1) < 0.005


def test_lstm_ops_are_added():
    import torch

    lstm = torch.nn.LSTM(64, 16, bidirectional=True)

    class Seq(torch.nn.Module):
        def forward(self, x):  # (1, C, T) → the LSTM over T
            return lstm(x.permute(2, 0, 1))[0]

    seq = Seq()
    seq.lstm = lstm
    assert bounds.flops_per_window(seq, 64, 47) == 2 * (64 + 16) * 4 * 16 * 47 * 2
