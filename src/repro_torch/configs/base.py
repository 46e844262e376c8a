"""Architecture configuration schema.

One dataclass drives every model family in the zoo (dense / MoE / SSM /
hybrid / encoder-decoder / VLM- and audio-frontend LMs).  Exact public
configurations live in ``configs/<arch>.py``; reduced smoke variants are
derived with ``.smoke()``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    num_shared_experts: int = 0
    d_shared: int = 0             # shared-expert hidden size
    router_aux_loss: float = 0.0
    impl: str = "dense"           # "dense" (masked) | "ep" (all-to-all)


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16           # per-channel state size (Mamba N)
    conv_kernel: int = 4
    expand: int = 2
    chunk: int = 256              # chunked-scan block length


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8          # one sLSTM block per this many blocks
    mlstm_expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|encdec|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # attention details
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    logit_softcap: float = 0.0            # gemma2: 30.0 final / 50.0 attn
    attn_softcap: float = 0.0
    sliding_window: int = 0               # 0 = disabled
    local_global_pattern: bool = False    # gemma2: alternate local/global
    post_norms: bool = False              # gemma2: sandwich (pre+post) norms
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # family-specific
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # encoder-decoder (seamless-m4t): num_layers applies to each side
    encoder_layers: int = 0
    # frontends (vlm/audio): stub embeddings prepended to the token stream
    frontend_tokens: int = 0              # patches / frames per example
    # execution policy
    tp_degree: int = 16                   # 1 = pure DP (mesh 'model' axis
                                          # joins the data axes)
    kv_quant: bool = False                # int8 KV cache (per-row scales)
    dtype: str = "bfloat16"               # compute dtype
    param_dtype: str = "float32"
    remat: bool = True                    # activation checkpointing per layer
    scan_layers: bool = True              # scan over stacked layer params
    use_pallas: bool = False              # Pallas kernels (TPU target only);
                                          # kept for parity: repro_torch's
                                          # models never read it
    cost_analysis_mode: bool = False      # unrolled/direct paths: HLO cost
                                          # analysis counts scan bodies once,
                                          # so cost-extrapolation variants
                                          # avoid inner scans entirely
    # full attention? -> long_500k cell is skipped (needs sub-quadratic)
    subquadratic: bool = False
    # decode support (encoder-only archs would set False; all ours decode)
    supports_decode: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def embed_scale(self) -> float:
        """Factor on the token embeddings: ``sqrt(d_model)`` for the gemma
        family (its published recipe), else 1.  The reference decides this
        inside its model code by the config's name; here the config
        decides it once, and the model reads it."""
        return self.d_model ** 0.5 if self.name.startswith("gemma") else 1.0

    def smoke(self) -> "ArchConfig":
        """Reduced config of the same family for CPU smoke tests."""
        changes = dict(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            d_ff=256,
            head_dim=32,
            vocab_size=512,
            frontend_tokens=min(self.frontend_tokens, 8),
            encoder_layers=min(self.encoder_layers, 2),
            dtype="float32",
            remat=False,
            scan_layers=self.scan_layers,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=8, top_k=2, d_expert=64,
                d_shared=64 if self.moe.num_shared_experts else 0)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(self.ssm, state_dim=8,
                                                 chunk=16)
        if self.xlstm is not None:
            changes["xlstm"] = dataclasses.replace(self.xlstm, slstm_every=2,
                                                   chunk=16)
        return dataclasses.replace(self, **changes)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the dry-run matrix."""
    name: str                     # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def shape_applicable(cfg: ArchConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Per-spec skip rules: long_500k only for sub-quadratic archs;
    decode shapes only for archs with a decode step."""
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: long_500k needs sub-quadratic attention (skip per spec)"
    if cell.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    return True, ""
