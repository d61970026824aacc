"""Architecture assembly: decoder stacks, hybrid interleave, enc-dec, VLM.

Port of `repro.models.transformer`.  Params keep the reference's tree:
block leaves stacked on a leading layer axis, so `core/ptq.quantize_tree`
picks the same leaves and gives per-(layer, channel) scales.  The layer
loop is a Python `for` over that axis (`layer` indexes every leaf, a
`QuantTensor`'s words and scales too).

Entry points (all functions of (cfg, params, ...)):
    init_params(cfg, generator, device=)       -> (params, axes)
    forward(cfg, params, batch)                -> (logits, aux)   [train/prefill math]
    loss_fn(cfg, params, batch)                -> (loss, {"ce", "aux"})
    prefill(cfg, params, batch)                -> (last_logits, cache)
    decode_step(cfg, params, cache, token, pos) -> (logits, cache)   [cache updated in place]
    init_cache_shape(cfg, batch, max_len)      -> dict of meta tensors

The "mla_moe" family (DeepSeek-V3's block, `configs.base.LatentMoEConfig`)
keeps its `first_dense_layers` in a stack of their own ("dense_blocks",
gated MLP) before the MoE stack ("blocks"); its cache is the latent one
of `models/mla.py`, "ckv" and "kpe" with a leading layer axis.  Its
`decode_step` takes a position a slot (`pos` of shape (B,)), and its
`prefill` can write a prompt's rows into given slots of a cache.  With a
`span` (the port's tracer on), both record a child span a layer ("mla",
then "dense_mlp" or "moe") and "lm_head"; a "moe" span's expert load is
tagged after the step's last device read (`tag_expert_load`).

The "kda_mla_moe" family (Kimi Linear's block, `configs.base.
HybridLatentMoEConfig`) has the same MLPs ("dense_blocks", "blocks", norms
with them) and two stacks of attention: "kda_blocks" (`models/kda.py`) for
the layers of `cfg.kda_layers` and "mla_blocks" for the others, in layer
order.  Its cache holds both kinds of state side by side, layer first:
the MLA layers' latent rows ("ckv", "kpe") and the KDA layers' float32
state ("kda_state", (L_kda, B, H, K, V)) and convolution tail
("kda_conv").  A prefill writes its slots' state and tail from zero; a
decode step updates them in place.  Its spans name each layer's attention
"kda" or "mla".
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.core.ptq import QuantTensor
from repro_torch.models import attention as attn
from repro_torch.models import kda, layers, mamba, mla, moe, rwkv6
from repro_torch.obs import trace

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_dense_block(draw, cfg, lead):
    pa, aa = attn.init_attention(draw, cfg, lead)
    n1, an1 = layers.init_norm(draw, cfg.d_model, cfg.norm, cfg.param_dtype, lead)
    n2, an2 = layers.init_norm(draw, cfg.d_model, cfg.norm, cfg.param_dtype, lead)
    if cfg.family == "moe":
        pm, am = moe.init_moe(draw, cfg, lead)
    else:
        pm, am = layers.init_mlp(draw, cfg.d_model, cfg.d_ff, cfg.mlp, cfg.param_dtype, lead)
    return ({"attn": pa, "mlp": pm, "norm1": n1, "norm2": n2},
            {"attn": aa, "mlp": am, "norm1": an1, "norm2": an2})


def _init_rwkv_layer(draw, cfg, lead):
    p, a = rwkv6.init_rwkv_block(draw, cfg, lead)
    n1, an1 = layers.init_norm(draw, cfg.d_model, cfg.norm, cfg.param_dtype, lead)
    n2, an2 = layers.init_norm(draw, cfg.d_model, cfg.norm, cfg.param_dtype, lead)
    return ({"rwkv": p, "norm1": n1, "norm2": n2},
            {"rwkv": a, "norm1": an1, "norm2": an2})


def _init_jamba_superblock(draw, cfg, lead):
    """P sublayers: mamba at all slots except attn_offset; MoE every moe_every-th."""
    P = cfg.attn_period
    n_moe = P // cfg.moe_every
    pm, am = mamba.init_mamba_block(draw, cfg, lead + (P - 1,))
    pa, aa = attn.init_attention(draw, cfg, lead)
    pmoe, amoe = moe.init_moe(draw, cfg, lead + (n_moe,))
    pmlp, amlp = layers.init_mlp(draw, cfg.d_model, cfg.d_ff, cfg.mlp, cfg.param_dtype,
                                 lead + (P - n_moe,))
    pn, an = layers.init_norm(draw, cfg.d_model, cfg.norm, cfg.param_dtype, lead + (2 * P,))
    return ({"mamba": pm, "attn": pa, "moe": pmoe, "mlp": pmlp, "norms": pn},
            {"mamba": am, "attn": aa, "moe": amoe, "mlp": amlp, "norms": an})


def _init_whisper_dec_block(draw, cfg, lead):
    psa, asa = attn.init_attention(draw, cfg, lead)
    pca, aca = attn.init_attention(draw, cfg, lead)
    pm, am = layers.init_mlp(draw, cfg.d_model, cfg.d_ff, cfg.mlp, cfg.param_dtype, lead)
    norms = [layers.init_norm(draw, cfg.d_model, cfg.norm, cfg.param_dtype, lead)
             for _ in range(3)]
    return ({"self": psa, "cross": pca, "mlp": pm,
             "norm1": norms[0][0], "norm2": norms[1][0], "norm3": norms[2][0]},
            {"self": asa, "cross": aca, "mlp": am,
             "norm1": norms[0][1], "norm2": norms[1][1], "norm3": norms[2][1]})


def _init_ffn_block(draw, cfg, lead, dense: bool):
    """A latent-attention model's layer less its attention: the two norms
    and the MLP (gated on a dense layer, routed experts on the others)."""
    n1, an1 = layers.init_norm(draw, cfg.d_model, "rmsnorm", cfg.param_dtype, lead)
    n2, an2 = layers.init_norm(draw, cfg.d_model, "rmsnorm", cfg.param_dtype, lead)
    if dense:
        pm, am = layers.init_mlp(draw, cfg.d_model, cfg.d_ff, "gated", cfg.param_dtype, lead)
    else:
        pm, am = moe.init_routed_moe(draw, cfg, lead)
    return ({"mlp": pm, "norm1": n1, "norm2": n2}, {"mlp": am, "norm1": an1, "norm2": an2})


def _init_mla_block(draw, cfg, lead, dense: bool):
    pa, aa = mla.init_mla(draw, cfg, lead)
    p, a = _init_ffn_block(draw, cfg, lead, dense)
    return {"attn": pa, **p}, {"attn": aa, **a}


def init_params(cfg, generator: torch.Generator | None = None, *,
                device: torch.device | str | None = None) -> tuple[dict, dict]:
    """The port's own draw, with the reference's shapes, dtypes and stds
    (torch cannot reproduce `jax.random`).  `generator` defaults to one
    seeded 0 on `device`; on the meta device nothing is allocated."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    draw = layers.Draw(generator, dev)
    pe, ae = layers.init_embed(draw, cfg.vocab_padded, cfg.d_model, cfg.param_dtype)
    nf, anf = layers.init_norm(draw, cfg.d_model, cfg.norm, cfg.param_dtype)
    params: dict = {"embed": pe, "final_norm": nf}
    axes: dict = {"embed": ae, "final_norm": anf}
    if not cfg.tie_embeddings:
        params["lm_head"], axes["lm_head"] = layers.init_linear(
            draw, cfg.d_model, cfg.vocab_padded, cfg.param_dtype, out_axis="vocab")

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        params["blocks"], axes["blocks"] = _init_dense_block(draw, cfg, (cfg.n_layers,))
    elif fam == "ssm":
        params["blocks"], axes["blocks"] = _init_rwkv_layer(draw, cfg, (cfg.n_layers,))
    elif fam == "hybrid":
        params["blocks"], axes["blocks"] = _init_jamba_superblock(
            draw, cfg, (cfg.n_layers // cfg.attn_period,))
    elif fam == "mla_moe":
        nd = cfg.first_dense_layers
        params["dense_blocks"], axes["dense_blocks"] = _init_mla_block(draw, cfg, (nd,), True)
        params["blocks"], axes["blocks"] = _init_mla_block(
            draw, cfg, (cfg.n_layers - nd,), False)
    elif fam == "kda_mla_moe":
        nd, nk = cfg.first_dense_layers, len(cfg.kda_layers)
        params["dense_blocks"], axes["dense_blocks"] = _init_ffn_block(draw, cfg, (nd,), True)
        params["blocks"], axes["blocks"] = _init_ffn_block(draw, cfg, (cfg.n_layers - nd,), False)
        params["kda_blocks"], axes["kda_blocks"] = kda.init_kda(draw, cfg, (nk,))
        params["mla_blocks"], axes["mla_blocks"] = mla.init_mla(draw, cfg, (cfg.n_layers - nk,))
    elif fam == "audio":
        params["enc_blocks"], axes["enc_blocks"] = _init_dense_block(
            draw, cfg, (cfg.encoder_layers,))
        params["blocks"], axes["blocks"] = _init_whisper_dec_block(draw, cfg, (cfg.n_layers,))
        params["enc_pos"] = draw.normal((cfg.encoder_frames, cfg.d_model), 0.02,
                                        cfg.param_dtype)
        params["dec_pos"] = draw.normal((32768, cfg.d_model), 0.02, cfg.param_dtype)
        axes["enc_pos"] = (None, None)
        axes["dec_pos"] = (None, None)
        params["enc_final_norm"], axes["enc_final_norm"] = layers.init_norm(
            draw, cfg.d_model, cfg.norm, cfg.param_dtype)
    if fam == "vlm":
        params["vision_proj"], axes["vision_proj"] = layers.init_linear(
            draw, cfg.vit_dim, cfg.d_model, cfg.param_dtype, in_axis=None, out_axis="fsdp")
    return params, axes


# ---------------------------------------------------------------------------
# stacked leaves
# ---------------------------------------------------------------------------

def layer(tree, i: int):
    """Layer `i` of a stacked tree: every leaf indexed on its leading axis,
    a `QuantTensor`'s words and its per-(layer, channel) scales alike."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantTensor):
        return QuantTensor(tree.q[i], tree.scale[i])
    return tree[i]


def unstack(tree) -> list:
    """The layers of a stacked tree, every leaf split once along its leading
    axis (`torch.unbind`).  Under autograd that is one node a leaf, whose
    backward stacks the layers' gradients once; indexing layer by layer
    would write a zero-filled full-size gradient for every layer."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        return [dict(zip(parts, layer_leaves)) for layer_leaves in zip(*parts.values())]
    if isinstance(tree, QuantTensor):
        return [QuantTensor(q, s) for q, s in zip(tree.q.unbind(0), tree.scale.unbind(0))]
    return list(tree.unbind(0))


def n_stacked(tree) -> int:
    """The length of a stacked tree's leading (layer) axis."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return (tree.q if isinstance(tree, QuantTensor) else tree).shape[0]


# ---------------------------------------------------------------------------
# block bodies
# ---------------------------------------------------------------------------

def _dense_body(cfg, x, blk, positions, *, causal=True):
    h, hn = layers.add_norm(x, attn.attention_block(
        layers.apply_norm(x, blk["norm1"], cfg.norm), blk["attn"], cfg,
        positions, causal=causal), blk["norm2"], cfg.norm)
    if cfg.family == "moe":
        y, aux = moe.moe_mlp(hn, blk["mlp"], cfg)
    else:
        y, aux = layers.mlp(hn, blk["mlp"], cfg.mlp, cfg.dtype), 0.0
    return h + y, aux


def _rwkv_body(cfg, x, blk):
    y, _ = rwkv6.time_mix(layers.apply_norm(x, blk["norm1"], cfg.norm), blk["rwkv"], cfg)
    h, hn = layers.add_norm(x, y, blk["norm2"], cfg.norm)
    y, _ = rwkv6.channel_mix(hn, blk["rwkv"], cfg)
    return h + y, 0.0


def _dense_mlp_index(cfg, s: int) -> int:
    """Index into the dense-mlp stack for sublayer s (non-MoE slots)."""
    return sum(1 for t in range(s) if t % cfg.moe_every != cfg.moe_every - 1)


def _jamba_mlp(cfg, x, blk, s: int, group_size: int = 512):
    """Sublayer s's MLP: MoE on every moe_every-th slot, else dense."""
    if s % cfg.moe_every == cfg.moe_every - 1:
        return moe.moe_mlp(x, layer(blk["moe"], s // cfg.moe_every), cfg,
                           group_size=group_size)
    return layers.mlp(x, layer(blk["mlp"], _dense_mlp_index(cfg, s)), cfg.mlp, cfg.dtype), 0.0


def _jamba_body(cfg, x, blk, positions):
    aux_total = 0.0
    mi = 0          # mamba sublayer index
    for s in range(cfg.attn_period):
        xn = layers.apply_norm(x, layer(blk["norms"], 2 * s), cfg.norm)
        if s == cfg.attn_offset:
            y = attn.attention_block(xn, blk["attn"], cfg, positions, causal=True)
        else:
            y, _ = mamba.mamba_block(xn, layer(blk["mamba"], mi), cfg)
            mi += 1
        x, xn = layers.add_norm(x, y, layer(blk["norms"], 2 * s + 1), cfg.norm)
        y, aux = _jamba_mlp(cfg, xn, blk, s)
        aux_total = aux_total + aux
        x = x + y
    return x, aux_total


def _whisper_dec_body(cfg, x, blk, positions, enc_k, enc_v):
    h, hn = layers.add_norm(x, attn.attention_block(
        layers.apply_norm(x, blk["norm1"], cfg.norm), blk["self"], cfg,
        positions, causal=True), blk["norm2"], cfg.norm)
    h, hn = layers.add_norm(h, attn.cross_attention_block(hn, blk["cross"], cfg, enc_k, enc_v),
                            blk["norm3"], cfg.norm)
    h = h + layers.mlp(hn, blk["mlp"], cfg.mlp, cfg.dtype)
    return h, 0.0


def _rms(cfg, x, p):
    return layers.rmsnorm(x, p["w"], cfg.norm_eps)


def _mla_ffn(cfg, h, blk, dense: bool, sp=None, capacity: int | None = None):
    """h + the layer's MLP of norm2(h): a gated MLP on a dense layer, the
    routed and shared experts on the others (`capacity` as in
    `moe.routed_moe`).  With `sp`, its span ("dense_mlp" or "moe", whose
    expert load is kept) is marked."""
    hn = _rms(cfg, h, blk["norm2"])
    load = [] if sp is not None and not dense else None
    if dense:
        y = layers.mlp(hn, blk["mlp"], "gated", cfg.dtype)
    else:
        y = moe.routed_moe(hn, blk["mlp"], cfg, capacity=capacity, load=load)
    if sp is not None:
        s = sp.mark("dense_mlp" if dense else "moe")
        if load:
            sp.loads.append((s, load[0]))
    return h + y


def _mla_body(cfg, x, blk, positions, dense: bool):
    """One DeepSeek-V3 layer, as published: h = x + MLA(norm1(x)), then
    h + MLP(norm2(h)) (a gated MLP on the dense layers, the routed and
    shared experts on the others), each sum in the compute dtype."""
    h = x + mla.mla_block(_rms(cfg, x, blk["norm1"]), blk["attn"], cfg, positions)
    return _mla_ffn(cfg, h, blk, dense), 0.0


def _mla_stacks(params):
    """(layer params, dense?) of every layer of an mla_moe model, in order."""
    for name, dense in (("dense_blocks", True), ("blocks", False)):
        for blk in unstack(params[name]):
            yield blk, dense


def _latent_layers(cfg, params):
    """(attention kind "mla" or "kda", its params, its index in the cache's
    stack of that kind, the layer's params with its norms and MLP, dense?)
    of every layer of an mla_moe or kda_mla_moe model, in order."""
    if cfg.family == "mla_moe":
        for li, (blk, dense) in enumerate(_mla_stacks(params)):
            yield "mla", blk["attn"], li, blk, dense
        return
    attn = {"kda": unstack(params["kda_blocks"]), "mla": unstack(params["mla_blocks"])}
    seen = {"kda": 0, "mla": 0}
    for li, (blk, dense) in enumerate(_mla_stacks(params)):
        kind = "kda" if li in cfg.kda_layers else "mla"
        yield kind, attn[kind][seen[kind]], seen[kind], blk, dense
        seen[kind] += 1


class _LayerSpans:
    """Consecutive child spans of `parent`, each from the previous mark to
    this one; the "moe" spans' expert loads kept on the device until
    `tag_expert_load` reads them after the step."""

    def __init__(self, parent):
        self.tr, self.parent, self.t = trace.get(), parent, time.perf_counter()
        self.loads: list = []

    def mark(self, name: str):
        t = time.perf_counter()
        s = self.tr.emit(name, self.parent.trace_id, self.t, t, parent=self.parent)
        self.t = t
        return s

    def close(self):
        if self.loads:
            self.parent.tags["_expert_load"] = ([s for s, _ in self.loads],
                                                torch.stack([c for _, c in self.loads]))


def tag_expert_load(span) -> None:
    """After the step's device work is read back: tag each "moe" child of
    `span` with the most pairs any routed expert got (`tokens_max`) and
    the mean over the experts (`tokens_mean`)."""
    load = span.tags.pop("_expert_load", None) if span is not None else None
    if load is None:
        return
    spans, counts = load
    for s, c in zip(spans, counts.tolist()):
        s.tags["tokens_max"] = max(c)
        s.tags["tokens_mean"] = sum(c) / len(c)


def _scan_blocks(cfg, x, stacked, body):
    """x through the stacked blocks in order; body(x, blk) -> (x, aux).
    With `cfg.remat`, while autograd records, each block keeps only its
    inputs and recomputes its activations in the backward pass (the
    reference's `jax.checkpoint(body)`); gradients are the same."""
    def remat(x, blk):
        return checkpoint(body, x, blk, use_reentrant=False)
    fn = remat if cfg.remat and torch.is_grad_enabled() else body
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in unstack(stacked):
        x, a = fn(x, blk)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# forward (train / prefill math)
# ---------------------------------------------------------------------------

def _encode_audio(cfg, params, frames):
    """frames (B, F, d_model) — precomputed by the stub conv frontend."""
    x = frames.to(cfg.dtype) + params["enc_pos"][None, :frames.shape[1]].to(cfg.dtype)
    positions = torch.arange(frames.shape[1], device=x.device)
    x, _ = _scan_blocks(cfg, x, params["enc_blocks"],
                        lambda x, blk: _dense_body(cfg, x, blk, positions, causal=False))
    return layers.apply_norm(x, params["enc_final_norm"], cfg.norm)


def _logits(cfg, params, x):
    if cfg.tie_embeddings:
        w = layers._materialize(params["embed"]["w"], cfg.dtype)
        logits = torch.einsum("bsd,vd->bsv", x, w)
    else:
        logits = layers.linear(x, params["lm_head"], cfg.dtype)
    return logits.float()


def _vision_prefix(cfg, params, batch, x):
    v = layers.linear(batch["vision"].to(cfg.dtype), params["vision_proj"], cfg.dtype)
    return torch.cat([v, x[:, cfg.vision_tokens:]], dim=1)


def forward(cfg, params, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """batch: {"tokens": (B,S) int, optional "frames"/"vision"} ->
    (logits (B,S,vocab_padded) f32, aux)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = layers.embed(tokens, params["embed"], cfg.dtype)
    positions = torch.arange(S, device=x.device)
    fam = cfg.family

    if fam == "vlm":
        x = _vision_prefix(cfg, params, batch, x)
    if fam == "audio":
        x = x + params["dec_pos"][None, :S].to(cfg.dtype)
        enc_out = _encode_audio(cfg, params, batch["frames"])

        def body(x, blk):
            ek, ev = attn.encoder_kv(enc_out, blk["cross"], cfg)
            return _whisper_dec_body(cfg, x, blk, positions, ek, ev)
        x, aux = _scan_blocks(cfg, x, params["blocks"], body)
    elif fam in ("dense", "moe", "vlm"):
        x, aux = _scan_blocks(cfg, x, params["blocks"],
                              lambda x, blk: _dense_body(cfg, x, blk, positions))
    elif fam == "ssm":
        x, aux = _scan_blocks(cfg, x, params["blocks"], lambda x, blk: _rwkv_body(cfg, x, blk))
    elif fam == "hybrid":
        x, aux = _scan_blocks(cfg, x, params["blocks"],
                              lambda x, blk: _jamba_body(cfg, x, blk, positions))
    elif fam == "mla_moe":
        for name, dense in (("dense_blocks", True), ("blocks", False)):
            x, aux = _scan_blocks(cfg, x, params[name],
                                  lambda x, blk, d=dense: _mla_body(cfg, x, blk, positions, d))
        return _logits(cfg, params, _rms(cfg, x, params["final_norm"])), aux
    elif fam == "kda_mla_moe":
        for kind, pa, _, blk, dense in _latent_layers(cfg, params):
            xn = _rms(cfg, x, blk["norm1"])
            y = mla.mla_block(xn, pa, cfg, positions) if kind == "mla" else \
                kda.kda_prefill(xn, pa, cfg)[0]
            x = _mla_ffn(cfg, x + y, blk, dense)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return _logits(cfg, params, _rms(cfg, x, params["final_norm"])), aux
    else:
        raise ValueError(fam)
    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    return _logits(cfg, params, x), aux


def loss_fn(cfg, params, batch: dict) -> tuple[torch.Tensor, dict]:
    """Next-token CE (labels = batch['labels'])."""
    logits, aux = forward(cfg, params, batch)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    ce = torch.mean(lse - gold)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + decode with caches
# ---------------------------------------------------------------------------

def init_cache_shape(cfg, batch: int, max_len: int) -> dict:
    """The decode cache as meta tensors (shapes and dtypes, no memory)."""
    fam = cfg.family
    K, hd = cfg.n_kv_heads, cfg.head_dim
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    kv = lambda L: {"k": meta((L, batch, max_len, K, hd), cfg.dtype),
                    "v": meta((L, batch, max_len, K, hd), cfg.dtype)}
    if fam in ("dense", "moe", "vlm"):
        return kv(cfg.n_layers)
    if fam in ("mla_moe", "kda_mla_moe"):
        nk = len(cfg.kda_layers) if fam == "kda_mla_moe" else 0
        L = cfg.n_layers - nk
        out = {"ckv": meta((L, batch, max_len, cfg.kv_lora_rank), cfg.dtype),
               "kpe": meta((L, batch, max_len, cfg.qk_rope_head_dim), cfg.dtype)}
        if nk:
            H, K = cfg.kda_heads, cfg.kda_head_dim
            out["kda_state"] = meta((nk, batch, H, K, K), torch.float32)
            out["kda_conv"] = meta((nk, batch, cfg.short_conv_kernel_size - 1, 3 * H * K),
                                   cfg.dtype)
        return out
    if fam == "ssm":
        return {k: meta((cfg.n_layers,) + v.shape, v.dtype)
                for k, v in rwkv6.rwkv_state_shape(batch, cfg).items()}
    if fam == "hybrid":
        n_super = cfg.n_layers // cfg.attn_period
        out = kv(n_super)
        for k, v in mamba.mamba_state_shape(batch, cfg).items():
            out["mamba_" + k] = meta((n_super, cfg.attn_period - 1) + v.shape, v.dtype)
        return out
    if fam == "audio":
        out = kv(cfg.n_layers)
        for k in ("cross_k", "cross_v"):
            out[k] = meta((cfg.n_layers, batch, cfg.encoder_frames, K, hd), cfg.dtype)
        return out
    raise ValueError(fam)


def zeros_cache(cfg, batch: int, max_len: int, *, device=None) -> dict:
    dev = resolve_device(device)
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
            for k, v in init_cache_shape(cfg, batch, max_len).items()}


# families whose decode_step takes pos (B,)
PER_SLOT_POSITIONS = ("mla_moe", "kda_mla_moe")


def _mla_decode(cfg, params, cache, token, pos, span=None):
    B = token.shape[0]
    pos_h = np.broadcast_to(np.asarray(pos, np.int64).reshape(-1), (B,))
    t_used = int(pos_h.max()) + 1
    x = layers.embed(token, params["embed"], cfg.dtype)   # (B,1,d)
    pos_t = torch.as_tensor(np.array(pos_h), device=x.device)
    sp = _LayerSpans(span) if span is not None else None
    for kind, pa, ci, blk, dense in _latent_layers(cfg, params):
        xn = _rms(cfg, x, blk["norm1"])
        if kind == "mla":
            y = mla.absorbed_decode(xn, pa, cfg, cache["ckv"][ci], cache["kpe"][ci], pos_t,
                                    t_used)
        else:
            y = kda.kda_decode(xn, pa, cfg, cache["kda_state"][ci], cache["kda_conv"][ci])
        if sp is not None:
            sp.mark(kind)
        x = _mla_ffn(cfg, x + y, blk, dense, sp, capacity=B)
    logits = _logits(cfg, params, _rms(cfg, x, params["final_norm"]))[:, 0]
    if sp is not None:
        sp.mark("lm_head")
        sp.close()
    return logits, cache


def decode_step(cfg, params, cache: dict, token: torch.Tensor, pos, *, span=None):
    """token (B,1) int; pos the current position (an int or a 0-d tensor;
    for the families of `PER_SLOT_POSITIONS` also one a slot, (B,)).
    Returns (logits (B, vocab_padded) f32, cache): the cache's tensors are
    updated in place (the reference donates its cache to the step).
    `span`: the parent of the layers' spans (those families only)."""
    if cfg.family in PER_SLOT_POSITIONS:
        return _mla_decode(cfg, params, cache, token, pos, span)
    B = token.shape[0]
    pos = int(pos)
    x = layers.embed(token, params["embed"], cfg.dtype)   # (B,1,d)
    fam = cfg.family

    if fam in ("dense", "moe", "vlm", "audio"):
        if fam == "audio":
            x = x + params["dec_pos"][None, pos].to(cfg.dtype)
        key_self = "self" if fam == "audio" else "attn"
        for i in range(n_stacked(params["blocks"])):
            blk = layer(params["blocks"], i)
            xn = layers.apply_norm(x, blk["norm1"], cfg.norm)
            y, _ = attn.decode_attention_block(xn, blk[key_self], cfg,
                                               attn.KVCache(cache["k"][i], cache["v"][i]), pos)
            if fam == "audio":
                x, xn = layers.add_norm(x, y, blk["norm2"], cfg.norm)
                x, xn = layers.add_norm(x, attn.cross_attention_block(
                    xn, blk["cross"], cfg, cache["cross_k"][i], cache["cross_v"][i]),
                    blk["norm3"], cfg.norm)
                x = x + layers.mlp(xn, blk["mlp"], cfg.mlp, cfg.dtype)
            else:
                x, xn = layers.add_norm(x, y, blk["norm2"], cfg.norm)
                if fam == "moe":
                    y, _ = moe.moe_mlp(xn, blk["mlp"], cfg, group_size=B)
                else:
                    y = layers.mlp(xn, blk["mlp"], cfg.mlp, cfg.dtype)
                x = x + y
    elif fam == "ssm":
        for i in range(n_stacked(params["blocks"])):
            blk = layer(params["blocks"], i)
            y, (xtm, wkv) = rwkv6.time_mix(
                layers.apply_norm(x, blk["norm1"], cfg.norm), blk["rwkv"], cfg,
                xprev_last=cache["x_tm"][i], state=cache["wkv"][i])
            x, xn = layers.add_norm(x, y, blk["norm2"], cfg.norm)
            y, xcm = rwkv6.channel_mix(xn, blk["rwkv"], cfg, xprev_last=cache["x_cm"][i])
            x = x + y
            cache["wkv"][i].copy_(wkv)
            cache["x_tm"][i].copy_(xtm)
            cache["x_cm"][i].copy_(xcm)
    elif fam == "hybrid":
        for i in range(n_stacked(params["blocks"])):
            blk = layer(params["blocks"], i)
            mi = 0
            for s in range(cfg.attn_period):
                xn = layers.apply_norm(x, layer(blk["norms"], 2 * s), cfg.norm)
                if s == cfg.attn_offset:
                    y, _ = attn.decode_attention_block(
                        xn, blk["attn"], cfg, attn.KVCache(cache["k"][i], cache["v"][i]), pos)
                else:
                    conv, ssm = cache["mamba_conv"][i, mi], cache["mamba_ssm"][i, mi]
                    y, nst = mamba.mamba_block(xn, layer(blk["mamba"], mi), cfg,
                                               state={"conv": conv, "ssm": ssm})
                    conv.copy_(nst["conv"])
                    ssm.copy_(nst["ssm"])
                    mi += 1
                x, xn = layers.add_norm(x, y, layer(blk["norms"], 2 * s + 1), cfg.norm)
                y, _ = _jamba_mlp(cfg, xn, blk, s, group_size=B)
                x = x + y
    else:
        raise ValueError(fam)

    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    return _logits(cfg, params, x)[:, 0], dict(cache)


def _mla_prefill(cfg, params, tokens, cache, slots, span):
    B, S = tokens.shape
    x = layers.embed(tokens, params["embed"], cfg.dtype)
    positions = torch.arange(S, device=x.device)
    sp = _LayerSpans(span) if span is not None else None
    if cache is None:
        cache = {k: torch.empty(v.shape, dtype=v.dtype, device=x.device)
                 for k, v in init_cache_shape(cfg, B, S).items()}
        slots = range(B)
    slots = torch.as_tensor(list(slots), device=x.device)
    for kind, pa, ci, blk, dense in _latent_layers(cfg, params):
        xn = _rms(cfg, x, blk["norm1"])
        if kind == "mla":
            o, ckv, kpe = mla.prefill_block(xn, pa, cfg, positions)
            cache["ckv"][ci, slots, :S] = ckv.to(cache["ckv"].dtype)
            cache["kpe"][ci, slots, :S] = kpe.to(cache["kpe"].dtype)
        else:
            o, state, tail = kda.kda_prefill(xn, pa, cfg)
            cache["kda_state"][ci, slots] = state
            cache["kda_conv"][ci, slots] = tail.to(cache["kda_conv"].dtype)
        if sp is not None:
            sp.mark(kind)
        x = _mla_ffn(cfg, x + o, blk, dense, sp)
    logits = _logits(cfg, params, _rms(cfg, x[:, -1:], params["final_norm"]))[:, -1]
    if sp is not None:
        sp.mark("lm_head")
        sp.close()
    return logits, cache


def prefill(cfg, params, batch: dict, *, cache: dict | None = None, slots=None, span=None):
    """Single-pass prompt processing: forward math + decode-cache
    materialization in the same layer loop.  Returns
    (last-position logits (B, vocab_padded), cache).  For mla_moe, with
    `cache` and `slots` (B slot indices) the prompts' rows are written
    into those slots of `cache`, in place, and `cache` is returned (for
    kda_mla_moe also their state and convolution tail, from zero);
    `span` as in `decode_step`."""
    if cfg.family in PER_SLOT_POSITIONS:
        return _mla_prefill(cfg, params, batch["tokens"], cache, slots, span)
    tokens = batch["tokens"]
    B, S = tokens.shape
    fam = cfg.family
    x = layers.embed(tokens, params["embed"], cfg.dtype)
    positions = torch.arange(S, device=x.device)
    q_chunk = min(cfg.q_chunk, S)

    def self_attention(x, p):
        """The attention sublayer, also returning its K/V for the cache."""
        q, k, v = attn._qkv(x, p, cfg, positions)
        o = attn.causal_attention(q, k, v, q_chunk=q_chunk)
        return layers.linear(o.reshape(B, S, -1), p["wo"], cfg.dtype), \
            k.to(cfg.dtype), v.to(cfg.dtype)

    stacked = params["blocks"]
    outs: dict[str, list] = {}

    def keep(**leaves):
        for k, v in leaves.items():
            outs.setdefault(k, []).append(v)

    if fam in ("dense", "moe", "vlm"):
        if fam == "vlm":
            x = _vision_prefix(cfg, params, batch, x)
        for i in range(n_stacked(stacked)):
            blk = layer(stacked, i)
            o, k, v = self_attention(layers.apply_norm(x, blk["norm1"], cfg.norm), blk["attn"])
            h, hn = layers.add_norm(x, o, blk["norm2"], cfg.norm)
            if fam == "moe":
                y, _ = moe.moe_mlp(hn, blk["mlp"], cfg)
            else:
                y = layers.mlp(hn, blk["mlp"], cfg.mlp, cfg.dtype)
            x = h + y
            keep(k=k, v=v)
    elif fam == "ssm":
        for i in range(n_stacked(stacked)):
            blk = layer(stacked, i)
            y, (xtm, wkv) = rwkv6.time_mix(
                layers.apply_norm(x, blk["norm1"], cfg.norm), blk["rwkv"], cfg)
            h, hn = layers.add_norm(x, y, blk["norm2"], cfg.norm)
            y, xcm = rwkv6.channel_mix(hn, blk["rwkv"], cfg)
            x = h + y
            keep(wkv=wkv.float(), x_tm=xtm.to(cfg.dtype), x_cm=xcm.to(cfg.dtype))
    elif fam == "hybrid":
        for i in range(n_stacked(stacked)):
            blk = layer(stacked, i)
            mi = 0
            convs, ssms = [], []
            for s in range(cfg.attn_period):
                xn = layers.apply_norm(x, layer(blk["norms"], 2 * s), cfg.norm)
                if s == cfg.attn_offset:
                    y, k, v = self_attention(xn, blk["attn"])
                    keep(k=k, v=v)
                else:
                    y, nst = mamba.mamba_block(xn, layer(blk["mamba"], mi), cfg)
                    convs.append(nst["conv"])
                    ssms.append(nst["ssm"])
                    mi += 1
                x, xn = layers.add_norm(x, y, layer(blk["norms"], 2 * s + 1), cfg.norm)
                y, _ = _jamba_mlp(cfg, xn, blk, s)
                x = x + y
            keep(mamba_conv=torch.stack(convs).to(cfg.dtype), mamba_ssm=torch.stack(ssms))
    elif fam == "audio":
        x = x + params["dec_pos"][None, :S].to(cfg.dtype)
        enc_out = _encode_audio(cfg, params, batch["frames"])
        for i in range(n_stacked(stacked)):
            blk = layer(stacked, i)
            ek, ev = attn.encoder_kv(enc_out, blk["cross"], cfg)
            o, k, v = self_attention(layers.apply_norm(x, blk["norm1"], cfg.norm), blk["self"])
            h, hn = layers.add_norm(x, o, blk["norm2"], cfg.norm)
            h, hn = layers.add_norm(h, attn.cross_attention_block(hn, blk["cross"], cfg, ek, ev),
                                    blk["norm3"], cfg.norm)
            x = h + layers.mlp(hn, blk["mlp"], cfg.mlp, cfg.dtype)
            keep(k=k, v=v, cross_k=ek.to(cfg.dtype), cross_v=ev.to(cfg.dtype))
    else:
        raise ValueError(fam)

    x = layers.apply_norm(x, params["final_norm"], cfg.norm)
    logits = _logits(cfg, params, x[:, -1:])
    return logits[:, -1], {k: torch.stack(v) for k, v in outs.items()}
