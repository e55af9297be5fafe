"""Conformer-CTC and Conformer-Transducer configs (counterpart of
nemo_tpu/models/asr/configs.py)."""

from __future__ import annotations

from typing import List, Optional

from nemo_tpu_torch.core.config import ConfigDict

# Reference char vocabulary for English ASR (quartznet15x5.yaml labels)
EN_CHAR_LABELS = [
    " ", "a", "b", "c", "d", "e", "f", "g", "h", "i", "j", "k", "l", "m",
    "n", "o", "p", "q", "r", "s", "t", "u", "v", "w", "x", "y", "z", "'",
]

_CONFORMER_SIZES = {
    # name: (d_model, n_layers, n_heads)  — conformer_ctc_bpe.yaml:7-17
    "small": (176, 16, 4),
    "medium": (256, 18, 4),
    "large": (512, 18, 8),
    "xlarge": (1024, 24, 8),
}


def conformer_ctc(
    size: str = "large",
    labels: Optional[List[str]] = None,
    feat_in: int = 80,
    subsampling: str = "striding",
    subsampling_factor: int = 4,
    compute_dtype: str = "float32",
    att_impl: str = "decomposed",
    fused_subsampling: bool = False,
) -> ConfigDict:
    """Conformer-CTC: mel-80 → ConvSubsampling ×4 → N×ConformerLayer
    (rel-pos MHSA, conv k=31) → 1×1 CTC head.

    `att_impl="decomposed_flash"` routes attention through the rel-pos
    flash kernel and `fused_subsampling=True` routes subsampling through the
    fused conv-ReLU-conv kernel (the same two flags as the JAX config)."""
    labels = labels or EN_CHAR_LABELS
    d_model, n_layers, n_heads = _CONFORMER_SIZES[size]
    return ConfigDict(
        sample_rate=16000,
        labels=labels,
        preprocessor=dict(features=feat_in, window_size=0.025, window_stride=0.01,
                          normalize="per_feature", dither=1e-5, pad_to=0),
        encoder=dict(
            feat_in=feat_in,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            subsampling=subsampling,
            subsampling_factor=subsampling_factor,
            subsampling_conv_channels=-1,
            ff_expansion_factor=4,
            conv_kernel_size=31,
            conv_norm_type="batch_norm",
            dropout=0.1,
            dropout_att=0.1,
            xscaling=True,
            pos_emb_max_len=5000,
            compute_dtype=compute_dtype,
            att_impl=att_impl,
            fused_subsampling=fused_subsampling,
        ),
        decoder=dict(feat_in=d_model, vocabulary=labels),
    )


def conformer_transducer(
    size: str = "large",
    labels: Optional[List[str]] = None,
    compute_dtype: str = "float32",
    decoding_strategy: str = "greedy_batch",
) -> ConfigDict:
    """Conformer-Transducer: the `conformer_ctc` encoder + an LSTM prediction
    network (pred_hidden 640, 1 layer) + an additive joint (joint_hidden
    640), greedy label-looping decode by default (the JAX config's
    arguments). The kernel flags are set on `cfg.encoder` by the caller."""
    cfg = conformer_ctc(size, labels, compute_dtype=compute_dtype)
    cfg.decoder = ConfigDict(pred_hidden=640, pred_rnn_layers=1, vocabulary=cfg.labels)
    cfg.joint = ConfigDict(joint_hidden=640)
    cfg.decoding = ConfigDict(strategy=decoding_strategy, max_symbols=10)
    return cfg


def fastconformer_ctc(size: str = "large", labels: Optional[List[str]] = None) -> ConfigDict:
    """FastConformer: the `conformer_ctc` config with ×8 depthwise-striding
    subsampling through 256 channels (the JAX config's). The conv module
    keeps conformer_ctc's kernel of 31, as JAX's does (NeMo's FastConformer
    configs use 9)."""
    cfg = conformer_ctc(size, labels, subsampling="dw_striding", subsampling_factor=8)
    cfg.encoder.subsampling_conv_channels = 256
    return cfg
