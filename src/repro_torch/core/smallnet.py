"""smallNet — the paper's model over swappable inference backends (PyTorch).

Port of `repro.core.smallnet`.  Architecture (paper §III-A, Fig. 2):
    conv 1 filter 2x2, stride 1, SAME, sigmoid
    maxpool 2x2
    conv 1 filter 2x2, SAME, sigmoid
    maxpool 2x2
    flatten (7*7 = 49)
    dense 10, sigmoid
    Max Finder (argmax)
Parameter count: (2*2*1*1 + 1) * 2 + 49*10 + 10 = 510.

The graph lives once in `apply(params, images, backend=...)`; a backend
(core/backends.py) supplies the layer primitives: the float "ref" and
"plan", "cuda" and "cuda_plan" (the float kernels), the Qm.n "fixed" and
"fixed_cuda" (the fixed-point kernels) and "int8" (the `quant_matmul`
kernel).  Scores are float32 in (0, 1) on the float and int8 backends and
Qm.n int32 words on the fixed ones; `predict` takes both.

Device rule (core/device.py): images that are a tensor stay on its device;
anything else goes to `device`, which defaults to "cuda" and raises where
there is none.  Params are moved next to the images.  The reference's
`_constrain_batch` (a sharding hint to its compiler) has no counterpart:
`apply_sharded` runs a batch split across a serving mesh's devices
(`VisionEngine(mesh=)`).

Training (`init_params`, `forward_logits`, `loss_fn`; the loop is
`core/deploy.py`) runs on the `ref` backend's plain PyTorch ops under
autograd, as the reference's runs `jax.value_and_grad` over plain XLA ops:
no kernel of either package has a backward pass.  `init_params` draws from
a `torch.Generator`, since torch cannot reproduce `jax.random`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import backends as B
from repro_torch.core import fixed_point as fxp
from repro_torch.core import ptq
from repro_torch.core.device import as_device_tensor, resolve_device


def _glorot_uniform(shape: tuple, generator: torch.Generator | None) -> torch.Tensor:
    """`jax.nn.initializers.glorot_uniform` for an HWIO conv or (in, out)
    dense weight: U(-l, l), l = sqrt(6 / (fan_in + fan_out)), each fan the
    receptive field times the in or out channels."""
    receptive = math.prod(shape[:-2])
    limit = math.sqrt(6.0 / (receptive * (shape[-2] + shape[-1])))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


def init_params(generator: torch.Generator | None = None, *,
                device: torch.device | str | None = None) -> dict:
    """Fresh float params: glorot-uniform weights (conv fans 4 and 4, dense
    49 and 10), zero biases; 510 in all.  Drawn on the CPU from `generator`
    (torch's default generator when None), then moved to `device`, so a
    seeded generator gives the same params on every device."""
    dev = resolve_device(device)
    shapes = {"conv1": (2, 2, 1, 1), "conv2": (2, 2, 1, 1), "dense": (49, 10)}
    return {layer: {"w": _glorot_uniform(shape, generator).to(dev),
                    "b": torch.zeros(shape[-1], dtype=torch.float32, device=dev)}
            for layer, shape in shapes.items()}


def param_count(params: dict) -> int:
    return sum(int(torch.as_tensor(p).numel()) for p in B.tree_leaves(params))


def _images(images, device) -> torch.Tensor:
    return as_device_tensor(images, device, dtype=torch.float32)


def _conv_stages(be: B.Backend, p: dict, images: torch.Tensor) -> torch.Tensor:
    """Ingest + both conv->act->pool stages: images -> pooled feature maps
    ((B,7,7) words or (B,7,7,1) floats for 28x28 inputs; any extent divides
    through as H/4 x W/4)."""
    x = be.ingest(images)
    x = be.fused_conv_act_pool(x, p["conv1"]["w"], p["conv1"]["b"])
    return be.fused_conv_act_pool(x, p["conv2"]["w"], p["conv2"]["b"])


def _dense_preact(be: B.Backend, p: dict, feats: torch.Tensor, scale=None) -> torch.Tensor:
    """Pooled feature maps -> PRE-activation class scores (B, 10); `scale`
    is the whole batch's `batch_scale` where the batch was split."""
    return be.dense(be.flatten(feats), p["dense"]["w"], p["dense"]["b"], scale)


def conv_trunk(params: dict, images, *, backend: str | B.Backend = "fixed_cuda",
               device: torch.device | str | None = None) -> torch.Tensor:
    """The conv half of the pipeline: images (B,H,W,1) -> pooled feature maps
    ((B,H/4,W/4) words, (B,H/4,W/4,1) floats).  `apply(params, x) ==
    dense_head(params, conv_trunk(params, x))`.  A single frame of the
    pooled-lattice geometry takes the backend's `frame_trunk` fast path (one
    `frame_trunk` launch on `fixed_cuda`); its interior map is
    word-identical to the composed stages, which every other input runs."""
    be = B.get_backend(backend)
    x = _images(images, device)
    p = be.prepare_params(params, x.device)
    if x.ndim == 4 and x.shape[0] == 1:
        quad = be.frame_trunk(x, p)
        if quad is not None:
            return quad[0]                     # interior == the plain trunk
    return _conv_stages(be, p, x)


def dense_head(params: dict, feats, *, backend: str | B.Backend = "fixed_cuda",
               device: torch.device | str | None = None) -> torch.Tensor:
    """The 49->10 dense classifier + output sigmoid over pooled feature maps
    ((B,7,7) words, (B,7,7,1) floats, or already-flat (B,49))."""
    be = B.get_backend(backend)
    feats = as_device_tensor(feats, device)
    p = be.prepare_params(params, feats.device)
    return be.sigmoid(_dense_preact(be, p, feats))


def apply(params: dict, images, *, backend: str | B.Backend = "fixed_cuda",
          device: torch.device | str | None = None) -> torch.Tensor:
    """Single entry point: images (B,28,28,1) -> class scores (B,10).

    `params` may be float (quantized on the way in, idempotently) or
    already backend-native (the int32 words of `quantize_params_fixed`, the
    QuantTensors of `quantize_params_int8`).  Scores are float32 in (0, 1)
    on the float and int8 backends and Qm.n int32 words on the fixed ones;
    `predict` is the Max Finder over either."""
    be = B.get_backend(backend)
    x = _images(images, device)
    return apply_sharded([be.prepare_params(params, x.device)], [x], backend=be)[0]


def apply_sharded(params: list, shards: list[torch.Tensor], *,
                  backend: str | B.Backend = "fixed_cuda") -> list[torch.Tensor]:
    """`apply` over a batch split in `shards` (image tensors, each on its
    own device; `params[i]` backend-native on shard i's): the scores of
    each shard, equal to its rows of the unsharded batch's.  A backend's
    `net_scores` hook, where it gives scores, takes the whole forward
    (`fixed_cuda`, `cuda`, `cuda_plan`: one launch a shard for the images
    its kernel takes); otherwise the stages compose, and the dense layer
    takes the backend's `batch_scale` over every shard (int8's activation
    scale, which the reference's sharded step reduces across its mesh).
    Every shard is launched before any is waited for."""
    be = B.get_backend(backend)
    scores = [be.net_scores(x, p) for p, x in zip(params, shards)]
    if all(s is not None for s in scores):
        return scores
    feats = [_conv_stages(be, p, x) for p, x in zip(params, shards)]
    scale = be.batch_scale(feats)
    return [be.sigmoid(_dense_preact(be, p, f, None if scale is None else scale.to(f.device)))
            for p, f in zip(params, feats)]


def forward(params: dict, images, *, sigmoid=torch.sigmoid,
            device: torch.device | str | None = None) -> torch.Tensor:
    """images (B,28,28,1) -> class scores (B,10) on the float path, with
    `sigmoid` as the activation ("ref" for `torch.sigmoid`, "plan" for the
    float PLAN, else a one-off backend around the given function)."""
    if sigmoid is torch.sigmoid:
        return apply(params, images, backend="ref", device=device)
    if sigmoid is fxp.sigmoid_plan_f32:
        return apply(params, images, backend="plan", device=device)
    return apply(params, images, backend=B.Backend(name="custom", sigmoid_fn=sigmoid),
                 device=device)


def forward_plan(params: dict, images, *,
                 device: torch.device | str | None = None) -> torch.Tensor:
    return apply(params, images, backend="plan", device=device)


def forward_int8(qparams: dict, images, *,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """int8 weights (dequant-on-use for the convs; the dense layer an int8
    MAC through the `quant_matmul` kernel)."""
    return apply(qparams, images, backend="int8", device=device)


def forward_fixed(qparams: dict, images, cfg: fxp.FixedPointConfig = fxp.Q16_16, *,
                  device: torch.device | str | None = None) -> torch.Tensor:
    """Bit-faithful fixed-point inference on the plain `fixed` backend:
    images float in [0,1] -> class-score words (B,10) int32."""
    be = B.get_backend("fixed") if cfg == fxp.Q16_16 else B.FixedBackend(cfg=cfg)
    return apply(qparams, images, backend=be, device=device)


def quantize_params_fixed(params: dict, cfg: fxp.FixedPointConfig = fxp.Q16_16, *,
                          device: torch.device | str | None = None) -> dict:
    """The paper's §III-B weight extraction: float weights -> int32 words."""
    be = B.FixedBackend(cfg=cfg)
    return be.quantize_params(
        B.tree_map(lambda leaf: as_device_tensor(leaf, device), params))


def quantize_params_int8(params: dict, cfg: ptq.QuantConfig = ptq.QuantConfig(), *,
                         device: torch.device | str | None = None) -> dict:
    """Float weights -> int8 QuantTensors (per-channel scales); biases stay
    float."""
    return ptq.quantize_tree(
        B.tree_map(lambda leaf: as_device_tensor(leaf, device), params), cfg)


def predict(scores) -> torch.Tensor:
    """The paper's Max Finder: the index of the largest score, the FIRST one
    on a tie (as `jnp.argmax`).  PLAN saturates to `one` for |x| >= 5, so
    tied top scores are common; the first index is picked explicitly rather
    than left to a device's argmax."""
    scores = torch.as_tensor(scores)
    n = scores.shape[-1]
    top = scores.max(dim=-1, keepdim=True).values
    idx = torch.arange(n, device=scores.device).expand_as(scores)
    return torch.where(scores == top, idx, n).min(dim=-1).values


def forward_logits(params: dict, images, *,
                   device: torch.device | str | None = None) -> torch.Tensor:
    """Pre-sigmoid class scores (B,10) on the float `ref` path: the deployed
    net up to and including the dense layer.  Sigmoid is monotone, so
    argmax over these equals the Max Finder over the deployed scores.
    Differentiable in `params` (plain PyTorch ops throughout)."""
    be = B.get_backend("ref")
    x = _images(images, device)
    p = be.prepare_params(params, x.device)
    return _dense_preact(be, p, _conv_stages(be, p, x))


def loss_fn(params: dict, images, labels) -> torch.Tensor:
    """Categorical crossentropy (paper §III-A) on the PRE-sigmoid logits,
    as the reference's training objective: CCE through the output sigmoid
    has vanishing gradients at this width, and log_softmax is
    shift-invariant while sigmoid is monotone, so the deployed net (sigmoid
    + Max Finder) is unchanged; only the training signal differs."""
    logits = forward_logits(params, images)
    labels = as_device_tensor(labels, logits.device).long()
    logp = torch.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels, logits.shape[-1]).to(logp.dtype)
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def accuracy(apply_fn, params, images, labels, batch: int = 256) -> float:
    """Share of `images` whose Max Finder output equals `labels`, scored in
    batches of `batch` by `apply_fn(params, images_batch)`."""
    hits, n = 0, 0
    for s in range(0, len(images), batch):
        scores = apply_fn(params, images[s:s + batch])
        want = torch.as_tensor(labels[s:s + batch]).cpu()
        hits += int((predict(scores).cpu() == want).sum())
        n += int(want.shape[0])
    return hits / max(n, 1)
