"""Plain reference of the ``phasenet`` configuration: PhaseNet in plain
PyTorch, float32, no kernels and no batching of its own.

A frozen copy of the PhaseNet module of the repository's test oracle
(SeisBench 0.4 PhaseNet, the architecture the published ``volpick`` weights
were trained with). It imports nothing of the program. ``build(cfg)`` makes
the model the configuration file describes.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


class PhaseNetTorch(nn.Module):
    def __init__(self, in_channels=3, classes=3, depth=5, kernel_size=7, stride=4, filters_root=8):
        super().__init__()
        self.depth, self.kernel_size, self.stride = depth, kernel_size, stride
        self.activation = torch.relu
        self.inc = nn.Conv1d(in_channels, filters_root, kernel_size, padding="same")
        self.in_bn = nn.BatchNorm1d(filters_root, eps=1e-3)
        self.down_branch = nn.ModuleList()
        self.up_branch = nn.ModuleList()

        last_filters = filters_root
        for i in range(depth):
            filters = int(2**i * filters_root)
            conv_same = nn.Conv1d(last_filters, filters, kernel_size, padding="same", bias=False)
            last_filters = filters
            bn1 = nn.BatchNorm1d(filters, eps=1e-3)
            if i == depth - 1:
                conv_down, bn2 = None, None
            else:
                padding = 0 if i in (1, 2, 3) else kernel_size // 2
                conv_down = nn.Conv1d(filters, filters, kernel_size, stride, padding=padding, bias=False)
                bn2 = nn.BatchNorm1d(filters, eps=1e-3)
            self.down_branch.append(nn.ModuleList([conv_same, bn1, conv_down, bn2]))

        for i in range(depth - 1):
            filters = int(2 ** (3 - i) * filters_root)
            conv_up = nn.ConvTranspose1d(last_filters, filters, kernel_size, stride, bias=False)
            last_filters = filters
            bn1 = nn.BatchNorm1d(filters, eps=1e-3)
            conv_same = nn.Conv1d(2 * filters, filters, kernel_size, padding="same", bias=False)
            bn2 = nn.BatchNorm1d(filters, eps=1e-3)
            self.up_branch.append(nn.ModuleList([conv_up, bn1, conv_same, bn2]))

        self.out = nn.Conv1d(last_filters, classes, 1, padding="same")
        self.softmax = nn.Softmax(dim=1)

    @staticmethod
    def _merge_skip(skip, x):
        offset = (x.shape[-1] - skip.shape[-1]) // 2
        return torch.cat([skip, x[:, :, offset : offset + skip.shape[-1]]], dim=1)

    def forward(self, x, logits=False):
        x = self.activation(self.in_bn(self.inc(x)))
        skips = []
        for i, (conv_same, bn1, conv_down, bn2) in enumerate(self.down_branch):
            x = self.activation(bn1(conv_same(x)))
            if conv_down is not None:
                skips.append(x)
                if i == 1:
                    x = F.pad(x, (2, 3), "constant", 0)
                elif i == 2:
                    x = F.pad(x, (1, 3), "constant", 0)
                elif i == 3:
                    x = F.pad(x, (2, 3), "constant", 0)
                x = self.activation(bn2(conv_down(x)))
        for (conv_up, bn1, conv_same, bn2), skip in zip(self.up_branch, skips[::-1]):
            x = self.activation(bn1(conv_up(x)))
            x = self._merge_skip(skip, x)
            x = self.activation(bn2(conv_same(x)))
        x = self.out(x)
        return x if logits else self.softmax(x)




def build(cfg: dict) -> nn.Module:
    """The reference model at the configuration's sizes, in eval mode."""
    a = cfg["model_args"]
    return PhaseNetTorch(
        in_channels=a["in_channels"], classes=a["classes"], depth=a["depth"],
        kernel_size=a["kernel_size"], stride=a["stride"], filters_root=a["filters_root"],
    ).eval()
