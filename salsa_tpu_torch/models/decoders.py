"""SELD decoder (counterpart of `salsa_tpu.models.decoders` and `models/rnn.py`):
frequency pooling -> sequence decoder -> SED head FC->relu->FC and three DOA
heads with tanh, concatenated (x | y | z) per class; dropout `head_dropout`, 0.2,
before each head layer. Dropout acts only in training mode, drawn from each
`layers.Dropout`'s generator. `output_format` is accepted for config
compatibility; the pipeline applies it.

Sequence decoders (`decoder_type`):
  * gru / bigru: `nn.GRU`, whose gate order (r, z, n) and candidate
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn)) are the flax GRU's;
  * lstm / bilstm: `nn.LSTM`, gate order (i, f, g, o) as salsa_tpu's LSTMLayer;
  * transformer: the reference's `pe` buffer (1, d_model, 2000) of the
    0.1-scaled sin/cos table added to the input, then two post-LN encoder layers
    (`layers.TransformerEncoderLayer`) at d_model = the encoder's channels;
    longer sequences than the table raise.
The recurrent stacks have 2 layers, dropout `rnn_dropout` (0.3) between them.
Module names are the reference's torch names (`gru`, `lstm`, `pe`,
`decoder_layer.layers.{i}`, `event_fc_1`, ...). With rnn_dropout > 0 in training
mode a recurrent stack runs one layer at a time, each a one-layer module called
on that layer's weights (`torch.func.functional_call`), so that the dropout
between them is drawn as the other dropouts are (the built-in dropout of
nn.GRU/nn.LSTM draws from torch's global generator). Otherwise the stack runs as
one call: one layer at a time read 14-19 % slower on the serving request's
(4, 300, 512) GRU on an NVIDIA H100 80GB HBM3 at 700 W (16.64 against 14.54 ms and
13.67 against 11.52 ms in two runs of `chip_smoke.py` phase 5), the outputs
bit-equal.

`compute_dtype` ('bfloat16') follows flax's casts: the input and the frequency
pooling in bf16; the recurrences and the transformer in float32 (salsa_tpu's
RNNStack and transformer have no dtype, so their float32 parameters promote the
bf16 input); the head Linears in bf16, their outputs cast to float32 before the
tanh. The outputs are float32 in every case.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call

from salsa_tpu_torch.models.layers import (
    Dropout,
    Linear,
    TransformerEncoderLayer,
    resolve_dtype,
    sinusoid_position_encoding,
)

RNN_TYPES = {"gru": nn.GRU, "bigru": nn.GRU, "lstm": nn.LSTM, "bilstm": nn.LSTM}
POS_LEN = 2000  # the positional table's length (reference PositionalEncoding pos_len)
N_TRACKS = 3  # EINV2's tracks a branch


class PositionalEncoding(nn.Module):
    """The reference's `pe` module: buffer `pe` (1, d_model, pos_len), the
    0.1-scaled sin/cos table, added to a (B, T, d_model) sequence."""

    def __init__(self, d_model: int, pos_len: int = POS_LEN):
        super().__init__()
        table = sinusoid_position_encoding(pos_len, d_model).T[None]
        self.register_buffer("pe", torch.from_numpy(table.copy()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] > self.pe.shape[2]:
            raise ValueError(f"a sequence of {x.shape[1]} frames is longer than the "
                             f"transformer's positional table ({self.pe.shape[2]})")
        return x + self.pe[0, :, :x.shape[1]].T


class TransformerStack(nn.Module):
    """`layers.{i}`: the reference's nn.TransformerEncoder attribute layout; `layer`
    holds `TransformerEncoderLayer`'s keyword arguments."""

    def __init__(self, d_model: int, n_layers: int = 2, **layer):
        super().__init__()
        self.layers = nn.ModuleList(TransformerEncoderLayer(d_model, **layer)
                                    for _ in range(n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class SeldDecoder(nn.Module):
    def __init__(self, n_output_channels: int = 512, n_classes: int = 12,
                 output_format: str = "reg_xyz", decoder_type: str = "bigru",
                 decoder_size: int = 256, freq_pool: str = "avg",
                 head_dropout: float = 0.2, rnn_dropout: float = 0.3,
                 compute_dtype: str | None = None):
        super().__init__()
        if decoder_type not in (*RNN_TYPES, "transformer"):
            raise ValueError(f"unknown decoder type '{decoder_type}'")
        if freq_pool not in ("avg", "max", "avg_max"):
            raise ValueError(f"unknown freq pool '{freq_pool}'")
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.freq_pool = freq_pool
        self.decoder_type = decoder_type
        self.rnn_dropout = Dropout(rnn_dropout)
        if decoder_type == "transformer":
            self.pe = PositionalEncoding(n_output_channels)
            self.decoder_layer = TransformerStack(n_output_channels)
            fc = n_output_channels
        else:
            rnn_cls = RNN_TYPES[decoder_type]
            bidirectional = decoder_type.startswith("bi")
            # registered under the reference's name: `gru` or `lstm`
            setattr(self, decoder_type.removeprefix("bi"),
                    rnn_cls(n_output_channels, decoder_size, num_layers=2, batch_first=True,
                            bidirectional=bidirectional))
            fc = decoder_size * (2 if bidirectional else 1)
            # one-layer modules with no weights of their own (a tuple is not
            # registered as submodules): each runs on its layer's weights of the stack
            self._layers = tuple(rnn_cls(n_in, decoder_size, batch_first=True,
                                         bidirectional=bidirectional, device="meta")
                                 for n_in in (n_output_channels, fc))
        self.head_dropout = Dropout(head_dropout)
        for name in ("event", "x", "y", "z"):
            setattr(self, f"{name}_fc_1", Linear(fc, fc // 2, compute_dtype=self.compute_dtype))
            setattr(self, f"{name}_fc_2", Linear(fc // 2, n_classes,
                                                 compute_dtype=self.compute_dtype))

    @property
    def rnn(self) -> nn.RNNBase:
        """The recurrent stack (`gru` or `lstm`)."""
        return getattr(self, self.decoder_type.removeprefix("bi"))

    def _head(self, h: torch.Tensor, name: str) -> torch.Tensor:
        h = torch.relu(getattr(self, f"{name}_fc_1")(self.head_dropout(h)))
        return getattr(self, f"{name}_fc_2")(self.head_dropout(h)).float()

    def _per_layer(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T', C) -> (B, T', fc) through the recurrent stack a layer at a time,
        with rnn_dropout between the layers."""
        for layer, rnn in enumerate(self._layers):
            weights = {name: getattr(self.rnn, name.replace("_l0", f"_l{layer}"))
                       for name, _ in rnn.named_parameters()}
            x = functional_call(rnn, weights, (x,))[0]
            if layer < len(self._layers) - 1:
                x = self.rnn_dropout(x)
        return x

    def _recur(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T', C) -> (B, T', fc) through the sequence decoder, in float32."""
        x = x.float()
        if self.decoder_type == "transformer":
            return self.decoder_layer(self.pe(x))
        if self.training and self.rnn_dropout.p > 0:
            return self._per_layer(x)
        return self.rnn(x)[0]

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: (B, C, T', F') encoder output -> framewise outputs at T'."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
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


class EINV2Decoder(nn.Module):
    """EINV2's track decoder (arXiv:2010.13092) over `EINV2Encoder`'s (sed, doa)
    maps: each branch's mean over frequency, (B, T', C); then per track k one
    stack of `n_layers` post-LN transformer layers (no positional encoding) on
    each branch, `sed_stacks.{k}` and `doa_stacks.{k}`; then per track the heads
    `sed_heads.{k}`, Linear(C, n_classes) logits, and `doa_heads.{k}`,
    Linear(C, 3) -> tanh. Returns `event_frame_logit` (B, T', n_tracks, n_classes)
    and `doa_frame_output` (B, T', n_tracks, 3): the `tracks` output format.
    `EINV2Decoder.stack_frames` counts the frames every stack took (B T' a stack),
    over the process."""

    stack_frames = 0

    def __init__(self, n_output_channels: int = 512, n_classes: int = 12,
                 output_format: str = "tracks", n_tracks: int = N_TRACKS, n_layers: int = 2,
                 n_heads: int = 8, dim_feedforward: int = 1024, dropout: float = 0.2,
                 ln_eps: float = 1e-5, compute_dtype: str | None = None):
        super().__init__()
        if output_format != "tracks":
            raise ValueError(f"EINV2Decoder outputs tracks; output_format is '{output_format}'")
        if resolve_dtype(compute_dtype) is not None:
            raise ValueError(f"EINV2Decoder computes in float32 only, not '{compute_dtype}'")
        layer = dict(n_heads=n_heads, dim_feedforward=dim_feedforward, dropout=dropout,
                     eps=ln_eps)
        d = n_output_channels
        self.n_tracks = n_tracks
        self.sed_stacks = nn.ModuleList(TransformerStack(d, n_layers, **layer)
                                        for _ in range(n_tracks))
        self.doa_stacks = nn.ModuleList(TransformerStack(d, n_layers, **layer)
                                        for _ in range(n_tracks))
        self.sed_heads = nn.ModuleList(nn.Linear(d, n_classes) for _ in range(n_tracks))
        self.doa_heads = nn.ModuleList(nn.Linear(d, 3) for _ in range(n_tracks))

    def forward(self, maps: tuple[torch.Tensor, torch.Tensor]) -> dict[str, torch.Tensor]:
        sed, doa = (m.mean(dim=3).transpose(1, 2) for m in maps)  # (B, T', C) each
        EINV2Decoder.stack_frames += 2 * self.n_tracks * sed.shape[0] * sed.shape[1]
        event = torch.stack([head(stack(sed)) for stack, head in
                             zip(self.sed_stacks, self.sed_heads)], dim=2)
        xyz = torch.stack([torch.tanh(head(stack(doa))) for stack, head in
                           zip(self.doa_stacks, self.doa_heads)], dim=2)
        return {"event_frame_logit": event, "doa_frame_output": xyz}


DECODERS = {"SeldDecoder": SeldDecoder, "EINV2Decoder": EINV2Decoder}
