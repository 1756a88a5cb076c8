"""SELD decoder (counterpart of `salsa_tpu.models.decoders` and `models/rnn.py`):
frequency pooling -> 2-layer GRU/BiGRU (dropout `rnn_dropout`, 0.3, between
layers) -> SED head FC->relu->FC and three DOA heads with tanh, concatenated
(x | y | z) per class; dropout `head_dropout`, 0.2, before each head layer.
Dropout acts only in training mode, drawn from each `layers.Dropout`'s generator.
`output_format` is accepted for config compatibility; the pipeline applies it.

The recurrence is `nn.GRU`, whose gate order (r, z, n) and candidate
n = tanh(W_in x + b_in + r * (W_hn h + b_hn)) are the flax GRU's. Module names
are the reference's torch names (`gru`, `event_fc_1`, ...): `gru` is the 2-layer
stack and holds the weights. With rnn_dropout > 0 in training mode its layers run
one at a time, each a one-layer `nn.GRU` called on that layer's weights
(`torch.func.functional_call`), so that the dropout between them is drawn as the
other dropouts are (nn.GRU's built-in dropout draws from torch's global
generator). Otherwise the stack runs as one call: one layer at a time read
14-19 % slower on the serving request's (4, 300, 512) on an H100 (16.64 against
14.54 ms and 13.67 against 11.52 ms in two runs of `chip_smoke.py` phase 5), the
outputs bit-equal.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from salsa_tpu_torch.models.layers import Dropout


class SeldDecoder(nn.Module):
    def __init__(self, n_output_channels: int = 512, n_classes: int = 12,
                 output_format: str = "reg_xyz", decoder_type: str = "bigru",
                 decoder_size: int = 256, freq_pool: str = "avg",
                 head_dropout: float = 0.2, rnn_dropout: float = 0.3,
                 compute_dtype: str | None = None):
        super().__init__()
        if decoder_type not in ("gru", "bigru"):
            raise NotImplementedError(
                f"decoder_type '{decoder_type}' is not ported yet (lstm, bilstm and "
                "transformer: ROADMAP queue 1, slice 2)")
        if freq_pool not in ("avg", "max", "avg_max"):
            raise ValueError(f"unknown freq pool '{freq_pool}'")
        if compute_dtype is not None:
            raise NotImplementedError(
                "compute_dtype (bf16 autocast) is not ported yet: ROADMAP queue 1, slice 4")
        self.freq_pool = freq_pool
        bidirectional = decoder_type == "bigru"
        self.gru = nn.GRU(n_output_channels, decoder_size, num_layers=2, batch_first=True,
                          bidirectional=bidirectional)
        self.rnn_dropout = Dropout(rnn_dropout)
        fc = decoder_size * (2 if bidirectional else 1)
        # one-layer GRUs with no weights of their own (a tuple is not registered as
        # submodules): each runs on its layer's weights of `gru`
        self._layers = tuple(nn.GRU(n_in, decoder_size, batch_first=True,
                                    bidirectional=bidirectional, device="meta")
                             for n_in in (n_output_channels, fc))
        self.head_dropout = Dropout(head_dropout)
        for name in ("event", "x", "y", "z"):
            setattr(self, f"{name}_fc_1", nn.Linear(fc, fc // 2))
            setattr(self, f"{name}_fc_2", nn.Linear(fc // 2, n_classes))

    def _head(self, h: torch.Tensor, name: str) -> torch.Tensor:
        h = torch.relu(getattr(self, f"{name}_fc_1")(self.head_dropout(h)))
        return getattr(self, f"{name}_fc_2")(self.head_dropout(h))

    def _per_layer(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T', C) -> (B, T', fc) through the GRU stack a layer at a time, with
        rnn_dropout between the layers."""
        for layer, gru in enumerate(self._layers):
            weights = {name: getattr(self.gru, name.replace("_l0", f"_l{layer}"))
                       for name, _ in gru.named_parameters()}
            x = functional_call(gru, weights, (x,))[0]
            if layer < len(self._layers) - 1:
                x = self.rnn_dropout(x)
        return x

    def _recur(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T', C) -> (B, T', fc) through the GRU stack."""
        if self.training and self.rnn_dropout.p > 0:
            return self._per_layer(x)
        return self.gru(x)[0]

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (B, C, T', F') encoder output -> framewise outputs at T'."""
        if self.freq_pool == "avg":
            x = x.mean(dim=3)
        elif self.freq_pool == "max":
            x = x.amax(dim=3)
        else:
            x = x.mean(dim=3) + x.amax(dim=3)
        x = self._recur(x.transpose(1, 2))  # (B, T', C) -> (B, T', fc)
        event_logit = self._head(x, "event")
        doa = torch.cat([torch.tanh(self._head(x, axis)) for axis in ("x", "y", "z")], dim=-1)
        return {"event_frame_logit": event_logit, "doa_frame_output": doa}


DECODERS = {"SeldDecoder": SeldDecoder}
