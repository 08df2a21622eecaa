"""Plain reference of the ``eqtransformer`` configuration: EQTransformer in
plain PyTorch, float32, no kernels and no batching of its own.

A frozen copy of the EQTransformer modules of the repository's test oracle
(SeisBench 0.4 EQTransformer, the architecture the published ``volpick``
weights were trained with), so that later changes to the oracle or to the
program do not move the yardstick. It imports nothing of the program.
``build(cfg)`` makes the model the configuration file describes.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


class Encoder(nn.Module):
    def __init__(self, input_channels, filters, kernel_sizes, in_samples):
        super().__init__()
        convs, pools, self.paddings = [], [], []
        for in_c, out_c, k in zip([input_channels] + list(filters[:-1]), filters, kernel_sizes):
            convs.append(nn.Conv1d(in_c, out_c, k, padding=k // 2))
            padding = in_samples % 2
            self.paddings.append(padding)
            pools.append(nn.MaxPool1d(2, padding=padding))
            in_samples = (in_samples + padding) // 2
        self.convs = nn.ModuleList(convs)
        self.pools = nn.ModuleList(pools)

    def forward(self, x):
        for conv, pool in zip(self.convs, self.pools):
            x = torch.relu(conv(x))
            x = pool(x)
        return x


class Decoder(nn.Module):
    def __init__(self, input_channels, filters, kernel_sizes, out_samples):
        super().__init__()
        self.upsample = nn.Upsample(scale_factor=2, mode="nearest")
        self.crops = []
        cur = out_samples
        for i, _ in enumerate(filters):
            p = cur % 2
            cur = (cur + p) // 2
            if p == 1:
                self.crops.append(len(filters) - 1 - i)
        convs = []
        for in_c, out_c, k in zip([input_channels] + list(filters[:-1]), filters, kernel_sizes):
            convs.append(nn.Conv1d(in_c, out_c, k, padding=k // 2))
        self.convs = nn.ModuleList(convs)

    def forward(self, x):
        for i, conv in enumerate(self.convs):
            x = self.upsample(x)
            if i in self.crops:
                x = x[:, :, :-1]
            x = torch.relu(conv(x))
        return x


class ResCNNBlock(nn.Module):
    def __init__(self, filters, ks, drop_rate):
        super().__init__()
        self.manual_padding = ks == 2
        pad = 0 if self.manual_padding else ks // 2
        self.dropout = nn.Dropout2d(drop_rate)
        self.norm1 = nn.BatchNorm1d(filters, eps=1e-3)
        self.conv1 = nn.Conv1d(filters, filters, ks, padding=pad)
        self.norm2 = nn.BatchNorm1d(filters, eps=1e-3)
        self.conv2 = nn.Conv1d(filters, filters, ks, padding=pad)

    def forward(self, x):
        y = torch.relu(self.norm1(x))
        y = self.dropout(y)
        if self.manual_padding:
            y = F.pad(y, (0, 1), "constant", 0)
        y = self.conv1(y)
        y = torch.relu(self.norm2(y))
        y = self.dropout(y)
        if self.manual_padding:
            y = F.pad(y, (0, 1), "constant", 0)
        y = self.conv2(y)
        return x + y


class ResCNNStack(nn.Module):
    def __init__(self, kernels, filters, drop_rate):
        super().__init__()
        self.members = nn.ModuleList([ResCNNBlock(filters, k, drop_rate) for k in kernels])

    def forward(self, x):
        for m in self.members:
            x = m(x)
        return x


class BiLSTMBlock(nn.Module):
    def __init__(self, input_size, hidden_size, drop_rate):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, bidirectional=True)
        self.dropout = nn.Dropout(drop_rate)
        self.conv = nn.Conv1d(2 * hidden_size, hidden_size, 1)
        self.norm = nn.BatchNorm1d(hidden_size, eps=1e-3)

    def forward(self, x):
        x = x.permute(2, 0, 1)  # (N,C,W) → (W,N,C)
        x = self.lstm(x)[0]
        x = self.dropout(x)
        x = x.permute(1, 2, 0)
        x = self.conv(x)
        return self.norm(x)


class BiLSTMStack(nn.Module):
    def __init__(self, blocks, input_size, drop_rate, hidden_size=16):
        super().__init__()
        members = [BiLSTMBlock(input_size, hidden_size, drop_rate)] + [
            BiLSTMBlock(hidden_size, hidden_size, drop_rate) for _ in range(blocks - 1)
        ]
        self.members = nn.ModuleList(members)

    def forward(self, x):
        for m in self.members:
            x = m(x)
        return x


class SeqSelfAttention(nn.Module):
    def __init__(self, input_size, units=32, attention_width=None, eps=1e-5):
        super().__init__()
        self.attention_width = attention_width
        self.Wx = nn.Parameter(torch.zeros(input_size, units))
        self.Wt = nn.Parameter(torch.zeros(input_size, units))
        self.bh = nn.Parameter(torch.zeros(units))
        self.Wa = nn.Parameter(torch.zeros(units, 1))
        self.ba = nn.Parameter(torch.zeros(1))
        self.eps = eps

    def forward(self, x):
        x = x.permute(0, 2, 1)  # (N, W, C)
        q = torch.unsqueeze(torch.matmul(x, self.Wt), 2)
        k = torch.unsqueeze(torch.matmul(x, self.Wx), 1)
        h = torch.tanh(q + k + self.bh)
        e = torch.squeeze(torch.matmul(h, self.Wa) + self.ba, -1)
        e = e - torch.max(e, dim=-1, keepdim=True).values
        e = torch.exp(e)
        if self.attention_width is not None:
            idx = torch.arange(0, e.shape[1], device=e.device)
            lower = idx - self.attention_width // 2
            upper = lower + self.attention_width
            mask = (idx[None, :] >= lower[:, None]) & (idx[None, :] < upper[:, None])
            e = torch.where(mask[None], e, torch.zeros_like(e))
        a = e / (torch.sum(e, dim=-1, keepdim=True) + self.eps)
        v = torch.matmul(a, x)
        return v.permute(0, 2, 1), a


class LayerNormalization(nn.Module):
    def __init__(self, filters, eps=1e-14):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(filters, 1))
        self.beta = nn.Parameter(torch.zeros(filters, 1))
        self.eps = eps

    def forward(self, x):
        mean = x.mean(1, keepdim=True)
        var = ((x - mean) ** 2).mean(1, keepdim=True)
        std = (var + self.eps).sqrt()
        return self.gamma * (x - mean) / std + self.beta


class FeedForward(nn.Module):
    def __init__(self, io_size, drop_rate, hidden_size=128):
        super().__init__()
        self.lin1 = nn.Linear(io_size, hidden_size)
        self.lin2 = nn.Linear(hidden_size, io_size)
        self.dropout = nn.Dropout(drop_rate)

    def forward(self, x):
        x = x.permute(0, 2, 1)
        x = torch.relu(self.lin1(x))
        x = self.dropout(x)
        x = self.lin2(x)
        return x.permute(0, 2, 1)


class Transformer(nn.Module):
    def __init__(self, input_size, drop_rate, attention_width=None, eps=1e-5):
        super().__init__()
        self.attention = SeqSelfAttention(input_size, attention_width=attention_width, eps=eps)
        self.norm1 = LayerNormalization(input_size)
        self.ff = FeedForward(input_size, drop_rate)
        self.norm2 = LayerNormalization(input_size)

    def forward(self, x):
        y, weight = self.attention(x)
        y = x + y
        y = self.norm1(y)
        y2 = self.ff(y)
        y2 = y + y2
        return self.norm2(y2), weight


class EQTransformerTorch(nn.Module):
    def __init__(self, in_channels=3, in_samples=6000, lstm_blocks=3, drop_rate=0.1):
        super().__init__()
        self.filters = [8, 16, 16, 32, 32, 64, 64]
        self.kernel_sizes = [11, 9, 7, 7, 5, 5, 3]
        self.res_cnn_kernels = [3, 3, 3, 3, 2, 3, 2]
        self.encoder = Encoder(in_channels, self.filters, self.kernel_sizes, in_samples)
        self.res_cnn_stack = ResCNNStack(self.res_cnn_kernels, self.filters[-1], drop_rate)
        self.bi_lstm_stack = BiLSTMStack(lstm_blocks, self.filters[-1], drop_rate)
        self.transformer_d0 = Transformer(16, drop_rate)
        self.transformer_d = Transformer(16, drop_rate)
        self.decoder_d = Decoder(16, self.filters[::-1], self.kernel_sizes[::-1], in_samples)
        self.conv_d = nn.Conv1d(self.filters[0], 1, 11, padding=5)
        self.dropout = nn.Dropout(drop_rate)
        self.pick_lstms = nn.ModuleList([nn.LSTM(16, 16) for _ in range(2)])
        self.pick_attentions = nn.ModuleList(
            [SeqSelfAttention(16, attention_width=3) for _ in range(2)]
        )
        self.pick_decoders = nn.ModuleList(
            [Decoder(16, self.filters[::-1], self.kernel_sizes[::-1], in_samples) for _ in range(2)]
        )
        self.pick_convs = nn.ModuleList([nn.Conv1d(self.filters[0], 1, 11, padding=5) for _ in range(2)])

    def forward(self, x):
        x = self.encoder(x)
        x = self.res_cnn_stack(x)
        x = self.bi_lstm_stack(x)
        x, _ = self.transformer_d0(x)
        x, _ = self.transformer_d(x)
        detection = torch.squeeze(torch.sigmoid(self.conv_d(self.decoder_d(x))), dim=1)
        outputs = [detection]
        for lstm_m, attention, decoder, conv in zip(
            self.pick_lstms, self.pick_attentions, self.pick_decoders, self.pick_convs
        ):
            px = x.permute(2, 0, 1)
            px = lstm_m(px)[0]
            px = self.dropout(px)
            px = px.permute(1, 2, 0)
            px, _ = attention(px)
            px = decoder(px)
            outputs.append(torch.squeeze(torch.sigmoid(conv(px)), dim=1))
        return tuple(outputs)


def build(cfg: dict) -> nn.Module:
    """The reference model at the configuration's sizes, in eval mode."""
    a = cfg["model_args"]
    return EQTransformerTorch(
        in_channels=a["in_channels"], in_samples=a["in_samples"], lstm_blocks=a["lstm_blocks"],
        drop_rate=a["drop_rate"],
    ).eval()
