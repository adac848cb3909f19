"""BERT MLM: the transformer family that has no prototxt.

Counterpart of ``sparknet_tpu/models/bert.py``: the same configs, the
same params tree (``embeddings``, ``layer_NN``, ``mlm_head``; weights
``(in, out)``; the decoder tied to ``embeddings.word``) and the Solver's
net protocol (``init``/``apply``/``loss_and_metrics``/``param_specs``/
``input_names``/``blob_shapes``), so ``Solver(model=...)`` trains it.

The numerics are the JAX package's: layer norm in f32 with the
population variance and ``rsqrt(var + eps)``; tanh GELU; ``mxu_dot``
for every projection and the tied decoder; one fused ``(h, 3h)`` QKV
product; attention through :func:`~sparknet_tpu_torch.ops.attention.attention`,
whose flash path runs the CUDA kernels on the card.

Randomness comes from the generator the caller passes (the solver's):
hidden dropout masks by ``torch.rand``, and each layer's attention
dropout seed by ``torch.randint`` into the offsets tensor the kernels
read, both drawn on the generator's device, so a step reads nothing back
to the host. Draws on a CPU generator are moved to the activations'
device, which lets a CPU run and a card run see the same seeds.

Batch blobs: ``input_ids``, ``token_type_ids``, ``attention_mask`` (1 =
real token) (B, S) int; ``mlm_positions``, ``mlm_labels`` (B, M) int;
``mlm_weights`` (B, M) float, 0 on unused prediction slots.

Not ported, each raising ``NotImplementedError`` naming itself: the MoE
FFN, tensor and expert parallelism (``tp_axis``, ``ep_axis``), the
sequence-parallel attentions ``"ring"`` and ``"ulysses"``, and ``remat``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.attention import attention
from ..ops.matmul import mxu_dot


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    # Mixture-of-Experts FFN (0 experts = dense FFN); not ported
    moe_num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_z_loss: float = 1e-3
    moe_aux_weight: float = 0.01
    moe_dispatch: str = "dense"
    # rematerialise each encoder layer; not ported
    remat: bool = False

    @classmethod
    def bert_base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def bert_small(cls) -> "BertConfig":
        return cls(hidden_size=256, num_layers=4, num_heads=4,
                   intermediate_size=1024)

    @classmethod
    def bert_tiny(cls, vocab_size: int = 1024) -> "BertConfig":
        return cls(vocab_size=vocab_size, hidden_size=128, num_layers=2,
                   num_heads=2, intermediate_size=512, max_position=128)


def _layer_norm(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _dropout(x, rate, generator, train):
    if not train or rate <= 0.0 or generator is None:
        return x
    u = torch.rand(x.shape, generator=generator, device=generator.device)
    keep = u.to(x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _trunc_normal(generator, shape, std):
    """N(0, 1) cut at +-2, times ``std``: inverse-CDF of a uniform drawn
    between erf(-2/sqrt2) and erf(2/sqrt2), as ``jax.random.truncated_normal``."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = lo + (hi - lo) * torch.rand(shape, generator=generator)
    return torch.clamp(math.sqrt(2.0) * torch.erfinv(u), -2.0, 2.0) * std


class BertMLM:
    """BERT encoder + tied-embedding MLM head on ``device``."""

    def __init__(
        self,
        config: BertConfig,
        input_shapes: Dict[str, Tuple[int, ...]],
        compute_dtype: torch.dtype = torch.float32,
        attention_impl: Optional[str] = None,
        tp_axis: Optional[str] = None,
        ep_axis: Optional[str] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        if config.moe_num_experts > 0:
            raise NotImplementedError(
                "BertMLM: the MoE FFN (moe_num_experts > 0) is not ported")
        if tp_axis is not None:
            raise NotImplementedError("BertMLM: tp_axis (tensor parallelism) is not ported")
        if ep_axis is not None:
            raise NotImplementedError("BertMLM: ep_axis (expert parallelism) is not ported")
        if attention_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"BertMLM: attention_impl={attention_impl!r} (sequence parallelism) "
                f"is not ported")
        if config.remat:
            raise NotImplementedError("BertMLM: remat is not ported")
        self.cfg = config
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        self.device = resolve_device(device)
        if "input_ids" not in input_shapes:
            raise ValueError("input_shapes must provide 'input_ids' (B, S)")
        b, s = input_shapes["input_ids"]
        m = input_shapes.get("mlm_positions", (b, max(1, s // 8)))[1]
        self.batch, self.seq_len, self.num_preds = b, s, m
        if s > config.max_position:
            raise ValueError(f"seq {s} > max_position {config.max_position}")
        if config.hidden_size % config.num_heads:
            raise ValueError(
                f"num_heads ({config.num_heads}) must divide hidden_size "
                f"({config.hidden_size})"
            )
        self.input_names: List[str] = [
            "input_ids", "token_type_ids", "attention_mask",
            "mlm_positions", "mlm_labels", "mlm_weights",
        ]
        self.blob_shapes: Dict[str, Tuple[int, ...]] = {
            "input_ids": (b, s),
            "token_type_ids": (b, s),
            "attention_mask": (b, s),
            "mlm_positions": (b, m),
            "mlm_labels": (b, m),
            "mlm_weights": (b, m),
            "loss": (),
            "mlm_acc": (),
        }

    # -- init ----------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None):
        """``(params, {})`` on the model's device, drawn from ``generator``
        (a CPU generator; seed 0 when None), so a seed gives the same
        weights on every device: truncated normals of std
        ``initializer_range``, layer-norm scales 1, biases 0."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        cfg = self.cfg
        h, i_sz, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        std = cfg.initializer_range

        def trunc(*shape):
            return _trunc_normal(generator, shape, std)

        params: Dict[str, Dict[str, torch.Tensor]] = {
            "embeddings": {
                "word": trunc(v, h),
                "position": trunc(cfg.max_position, h),
                "token_type": trunc(cfg.type_vocab_size, h),
                "ln_scale": torch.ones(h),
                "ln_bias": torch.zeros(h),
            }
        }
        for li in range(cfg.num_layers):
            params[f"layer_{li:02d}"] = {
                "q_w": trunc(h, h), "q_b": torch.zeros(h),
                "k_w": trunc(h, h), "k_b": torch.zeros(h),
                "v_w": trunc(h, h), "v_b": torch.zeros(h),
                "out_w": trunc(h, h), "out_b": torch.zeros(h),
                "attn_ln_scale": torch.ones(h), "attn_ln_bias": torch.zeros(h),
                "ffn_ln_scale": torch.ones(h), "ffn_ln_bias": torch.zeros(h),
                "ffn_in_w": trunc(h, i_sz), "ffn_in_b": torch.zeros(i_sz),
                "ffn_out_w": trunc(i_sz, h), "ffn_out_b": torch.zeros(h),
            }
        params["mlm_head"] = {
            "dense_w": trunc(h, h),
            "dense_b": torch.zeros(h),
            "ln_scale": torch.ones(h),
            "ln_bias": torch.zeros(h),
            # the decoder weight is tied to embeddings["word"]
            "output_bias": torch.zeros(v),
        }
        return {layer: {n: t.to(self.device) for n, t in e.items()}
                for layer, e in params.items()}, {}

    # -- encoder -------------------------------------------------------------
    def embed(self, params, batch, *, train: bool, generator=None):
        """Embedding sum + LN + dropout (the encoder prologue): ``(x,
        kv_mask)``, the mask as the int8 the kernels read."""
        cfg = self.cfg
        ids = batch["input_ids"].long()
        s = ids.shape[1]
        emb = params["embeddings"]
        pos_ids = batch.get("position_ids")
        pos_emb = (emb["position"][:s][None] if pos_ids is None
                   else emb["position"][pos_ids.long()])
        x = emb["word"][ids] + pos_emb + emb["token_type"][batch["token_type_ids"].long()]
        x = _layer_norm(x, emb["ln_scale"], emb["ln_bias"], cfg.layer_norm_eps)
        x = _dropout(x, cfg.hidden_dropout, generator, train)
        x = x.to(self.compute_dtype)
        kv_mask = (batch["attention_mask"] != 0).to(torch.int8)
        return x, kv_mask

    def encode_with_aux(self, params, batch, *, train: bool, generator=None):
        """(hidden states, aux loss); the aux loss is MoE's router loss, so
        0.0 for the dense FFN, the one this port takes."""
        x, kv_mask = self.embed(params, batch, train=train, generator=generator)
        aux_total = 0.0
        for li in range(self.cfg.num_layers):
            x, aux = self.layer_apply_with_aux(params[f"layer_{li:02d}"], x, kv_mask,
                                               generator, train)
            aux_total = aux_total + aux
        return x, aux_total

    def layer_apply_with_aux(self, lp, x, kv_mask, generator=None, train=False):
        """One encoder layer (attention + FFN, post-LN residuals):
        ``(x, aux)``."""
        cfg = self.cfg
        cdt = self.compute_dtype
        b, s, _ = x.shape
        hd = cfg.hidden_size // cfg.num_heads

        def proj(w, b_, t):
            return (mxu_dot(t, w.to(cdt)) + b_).to(cdt)

        nh = lp["q_w"].shape[-1] // hd
        # one fused (h, 3h) product, the same math as three: params stay
        # separate, so checkpoints are unchanged
        qkv = proj(
            torch.cat([lp["q_w"], lp["k_w"], lp["v_w"]], dim=1),
            torch.cat([lp["q_b"], lp["k_b"], lp["v_b"]]),
            x,
        ).view(b, s, 3, nh, hd)
        # (B,S,H,D) -> (B,H,S,D) views; the kernels take the strides
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        dropping = train and generator is not None and cfg.attention_dropout > 0
        ctx = attention(
            q, k, v, kv_mask=kv_mask, force=self.attention_impl,
            dropout_rate=cfg.attention_dropout if train else 0.0,
            dropout_rng=generator if dropping else None,
        )
        ctx = ctx.transpose(1, 2).reshape(b, s, nh * hd)
        attn_out = proj(lp["out_w"], lp["out_b"], ctx)
        attn_out = _dropout(attn_out, cfg.hidden_dropout, generator, train)
        x = _layer_norm(x + attn_out, lp["attn_ln_scale"], lp["attn_ln_bias"],
                        cfg.layer_norm_eps).to(cdt)
        ff = F.gelu(proj(lp["ffn_in_w"], lp["ffn_in_b"], x), approximate="tanh")
        ff = proj(lp["ffn_out_w"], lp["ffn_out_b"], ff)
        ff = _dropout(ff, cfg.hidden_dropout, generator, train)
        out = _layer_norm(x + ff, lp["ffn_ln_scale"], lp["ffn_ln_bias"],
                          cfg.layer_norm_eps).to(cdt)
        return out, 0.0

    # -- Solver protocol -----------------------------------------------------
    def apply(self, params, state, batch, *, train=None, generator=None):
        cfg = self.cfg
        train = bool(train)
        x, _ = self.encode_with_aux(params, batch, train=train,
                                    generator=generator if train else None)
        pos = batch["mlm_positions"].long()
        gathered = torch.gather(x, 1, pos[:, :, None].expand(-1, -1, x.shape[-1]))
        head = params["mlm_head"]
        t = F.gelu(mxu_dot(gathered, head["dense_w"].to(x.dtype)) + head["dense_b"],
                   approximate="tanh")
        t = _layer_norm(t, head["ln_scale"], head["ln_bias"], cfg.layer_norm_eps)
        logits = mxu_dot(
            t.to(self.compute_dtype),
            params["embeddings"]["word"].t().to(self.compute_dtype),
        ) + head["output_bias"]  # (B, M, V) f32
        labels = batch["mlm_labels"].long()
        weights = batch["mlm_weights"].float()
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        denom = torch.clamp(weights.sum(), min=1.0)
        loss = torch.sum(nll * weights) / denom
        acc = torch.sum((logits.argmax(-1) == labels).float() * weights) / denom
        return {"loss": loss, "mlm_acc": acc}, state

    def loss_and_metrics(self, blobs):
        return blobs["loss"], {"loss": blobs["loss"], "mlm_acc": blobs["mlm_acc"]}

    def param_specs(self):
        """BERT convention: no weight decay on biases and layer-norm params,
        as Caffe (lr_mult, decay_mult) pairs."""

        def spec_for(name: str) -> Tuple[float, float]:
            nodecay = (name.endswith("_b") or name.endswith("_bias") or "ln_" in name
                       or name == "output_bias")
            return (1.0, 0.0 if nodecay else 1.0)

        names = {
            "embeddings": ["word", "position", "token_type", "ln_scale", "ln_bias"],
            "mlm_head": ["dense_w", "dense_b", "ln_scale", "ln_bias", "output_bias"],
        }
        for li in range(self.cfg.num_layers):
            names[f"layer_{li:02d}"] = [
                "q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "out_w", "out_b",
                "attn_ln_scale", "attn_ln_bias",
                "ffn_in_w", "ffn_in_b", "ffn_out_w", "ffn_out_b",
                "ffn_ln_scale", "ffn_ln_bias",
            ]
        return {layer: {n: spec_for(n) for n in ns} for layer, ns in names.items()}

    def dummy_batch(self) -> Dict[str, torch.Tensor]:
        b, s, m = self.batch, self.seq_len, self.num_preds
        dev = self.device
        return {
            "input_ids": torch.zeros((b, s), dtype=torch.int32, device=dev),
            "token_type_ids": torch.zeros((b, s), dtype=torch.int32, device=dev),
            "attention_mask": torch.ones((b, s), dtype=torch.int32, device=dev),
            "mlm_positions": torch.zeros((b, m), dtype=torch.int32, device=dev),
            "mlm_labels": torch.zeros((b, m), dtype=torch.int32, device=dev),
            "mlm_weights": torch.ones((b, m), dtype=torch.float32, device=dev),
        }

    def num_params(self, params: Dict[str, Dict[str, Any]]) -> int:
        return sum(int(t.numel()) for lp in params.values() for t in lp.values())
