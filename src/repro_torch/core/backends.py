"""Backend dispatch for smallNet — one network graph, swappable substrates.

Port of `repro.core.backends`.  The graph lives once in `smallnet.apply`;
a backend supplies the five layer primitives

    conv2x2_same(x, w, b)   pre-activation 2x2 SAME conv
    maxpool2x2(x)           2x2/2 max pool
    dense(x, w, b)          pre-activation fully-connected layer
    sigmoid(x)              the activation unit
    quantize_params(params) float params -> backend-native parameters

plus the hooks `ingest`, `flatten`, `fused_conv_act`, `fused_conv_act_pool`,
`accumulate`, `mask_conv_weight`, `net_scores`, `frame_trunk`,
`sweep_stage`, `window_head`, `prepare_params` and `params_native`.  Parameters are a
dict of dicts of tensors with the reference's layouts: conv weights
(2,2,1,1) HWIO, conv bias (1,), dense (49,10) and (10,); the `int8`
backend's weights are `ptq.QuantTensor`s.
The base class is the float `ref` backend; float activations are NHWC
(B,H,W,1) float32, the fixed backends' (B,H,W) int32 words.

Registered backends (the reference's name in brackets where it differs):

    ref         float32 PyTorch ops, exact sigmoid (`torch.sigmoid`) — the
                Keras counterpart; the conv and pool are the plain versions
                of the float kernels
    plan        the same with the float PLAN sigmoid
    cuda        [pallas] the hand-written float kernels: a served step is
                one whole-net launch (`net_scores`, `float_smallnet`: both
                convs, pools, the dense layer and the exact sigmoid) where
                the kernel takes the images; a swept frame is three
                launches, one a trunk stage (`sweep_stage`,
                `float_sweep_stage`) and the window head (`window_head`,
                `float_window_head`); other batches, and the composed
                sweep, take the stages:
                the conv with its fused sigmoid epilogue and the max pool
                (`kernels/conv2d`, `kernels/maxpool2d`), the dense product,
                and `torch.sigmoid` after it, outside any kernel as in the
                reference; matches `ref`
    cuda_plan   [pallas_plan] the same with PLAN: one whole-net launch a
                served step, three a swept frame; the stages are the
                conv with the fused PLAN epilogue, the max pool, and the
                `sigmoid_pla` kernel after the dense layer (and the composed
                sweep head's); matches `plan`
    fixed       the bit-faithful Qm.n two's-complement datapath (paper
                §III-B) in PyTorch word ops — the plain versions of the
                kernels, on whatever device the tensors live on
    fixed_cuda  [fixed_pallas] the same words through the hand-written CUDA
                kernels (`kernels/fixed_conv`, `kernels/quant_matmul`,
                `kernels/frame_trunk`): a served step is one whole-net
                launch (`net_scores`) where the kernel takes the images
                (28x28, and other sizes up to about 170x170 words); other
                images take the stages, the fused conv -> PLAN -> maxpool
                stage one launch, then the dense launch and the PLAN
                sigmoid launch; a whole
                frame's trunk is one launch, and its window head one more
    int8        post-training int8: dequant-on-use plain convs, the PLAN
                sigmoid, and the dense layer as a true int8 MAC
                (activations quantized per tensor, weights per channel)
                through the `quant_matmul` kernel

The dense product `x @ w` of the float backends' stages stays
`torch.matmul`, as the reference leaves it to XLA; PyTorch computes a
float32 matmul in full float32 unless TF32 is switched on (the whole-net
kernel sums it on the CUDA cores, in another order).  On CPU tensors
every kernel wrapper runs its plain version.  `frame_trunk` is the whole-frame trunk of one
frame in one step: `fixed` runs the untiled plain version
(`frame_trunk_quad_plain`) and `fixed_cuda` launches the
`csrc/frame_trunk.cu` kernel (its plain version on CPU tensors).  Both
return None, as the reference's `FixedBackend` does, where the trunk
cannot tile: a batch other than 1, an extent that is not a multiple of 4
or is below 4, or a saturating config.  The float and int8 backends have
no `frame_trunk`.  `sweep_stage` is one stage of the frame sweep's trunk
in one step: `cuda` and `cuda_plan` launch `csrc/float_sweep.cu` (its
plain version on CPU tensors) for one frame whose maps have even
extents.  That is routing to the composed stages, not a fallback:
on valid geometry a build or launch failure raises.  The same holds for
`net_scores` (the whole net, for the images its kernel takes: `fixed_cuda`,
`cuda` and `cuda_plan`) and `window_head` (the sweep's head in one
launch: `fixed_cuda`, `cuda` and `cuda_plan`, the plain version on CPU
tensors): every other backend returns None and composes its stages.
`streaming/fcn_sweep` captures a frame whose route is all these one-launch
hooks in a CUDA graph and replays it (its module note).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core import ptq
from repro_torch.core.device import as_device_tensor
from repro_torch.kernels.conv2d.ops import (conv2d, conv2d_plain, float_smallnet,
                                            float_smallnet_fits, float_sweep_stage,
                                            float_window_head)
from repro_torch.kernels.fixed_conv.ops import (fixed_conv2d, fixed_conv2d_plain,
                                                fixed_maxpool2x2,
                                                fixed_maxpool2x2_plain,
                                                fixed_sigmoid, fixed_smallnet,
                                                smallnet_fits)
from repro_torch.kernels.frame_trunk.ops import (frame_trunk_quad,
                                                 frame_trunk_quad_plain)
from repro_torch.kernels.maxpool2d.ops import maxpool2d, maxpool2d_plain
from repro_torch.kernels.quant_matmul.ops import (fixed_dense, fixed_dense_plain,
                                                  fixed_window_head, quant_matmul)
from repro_torch.kernels.sigmoid_pla.ops import sigmoid_pla


def tree_map(fn, tree, is_leaf: Callable | None = None):
    """Apply `fn` to every leaf of a nest of dicts, lists, tuples and
    NamedTuples (such as `optim.AdamState`), each rebuilt as its type.  A
    `ptq.QuantTensor` is a node, mapped field by field (`q`, then `scale`),
    as the reference's registered pytree node is, unless `is_leaf` says it
    is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, ptq.QuantTensor):
        return ptq.QuantTensor(fn(tree.q), fn(tree.scale))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):        # a NamedTuple
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_leaves(tree, is_leaf: Callable | None = None) -> list:
    out = []
    tree_map(out.append, tree, is_leaf)
    return out


# ---------------------------------------------------------------------------
# Shared float primitives (the plain float datapath)
# ---------------------------------------------------------------------------

def conv_same_2x2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2x2 SAME conv, NHWC/HWIO, padded (0 before, 1 after) as Keras pads
    even kernels: the conv kernel's plain version."""
    return conv2d_plain(x, w, b, padding="SAME")


def maxpool_2x2(x: torch.Tensor) -> torch.Tensor:
    return maxpool2d_plain(x)


# ---------------------------------------------------------------------------
# Backend base class + registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Backend:
    """The float32 reference backend ("ref"); base class for all others.

    Subclasses override the five primitives; the hooks have float/NHWC
    defaults."""
    name: str = "ref"
    sigmoid_fn: Callable[[torch.Tensor], torch.Tensor] = torch.sigmoid

    # -- the five primitives ------------------------------------------------
    def quantize_params(self, params):
        """Float params -> backend-native params (identity here)."""
        return params

    def conv2x2_same(self, x, w, b):
        return conv_same_2x2(x, w, b)

    def maxpool2x2(self, x):
        return maxpool_2x2(x)

    def dense(self, x, w, b, scale=None):
        """`scale`: a whole batch's `batch_scale`, where the batch was split
        in shards; every backend but int8 ignores it."""
        return x @ w + b

    def sigmoid(self, x):
        return self.sigmoid_fn(x)

    # -- hooks --------------------------------------------------------------
    def params_native(self, params) -> bool:
        """True if `params` are already in this backend's native format."""
        return True

    def prepare_params(self, params, device: torch.device | str | None = None):
        """Idempotent: params as tensors on `device` (tensors stay where they
        are when it is None), quantized unless already native."""
        params = tree_map(lambda leaf: as_device_tensor(leaf, device), params)
        return params if self.params_native(params) else self.quantize_params(params)

    def ingest(self, images):
        """(B,H,W,1) float images -> backend activation tensor (NHWC float
        here)."""
        return images

    def flatten(self, x):
        return x.reshape(x.shape[0], -1)

    def fused_conv_act(self, x, w, b):
        """conv + activation; backends with a fused epilogue override this."""
        return self.sigmoid(self.conv2x2_same(x, w, b))

    def accumulate(self, a, b):
        """Add two pre-activation conv partial sums in this backend's word
        domain (the frame sweep's masked-tap decomposition)."""
        return a + b

    def mask_conv_weight(self, w, mask):
        """Zero out conv taps: w (2,2,1,1), mask (2,2) of 0/1.  Backends whose
        weights are not plain tensors (int8's QuantTensor) override."""
        return w * torch.as_tensor(mask, dtype=w.dtype, device=w.device).reshape(2, 2, 1, 1)

    def fused_conv_act_pool(self, x, w, b):
        """conv + activation + 2x2 maxpool — the full paper pipeline stage.
        The default composes two hooks; `fixed_cuda` fuses it into one
        launch."""
        return self.maxpool2x2(self.fused_conv_act(x, w, b))

    def batch_scale(self, feats):
        """The dense layer's statistic over a whole batch whose pooled
        feature maps are split in `feats` (one tensor a shard), or None
        where each shard's own is the batch's: every backend's forward is
        per image but int8's."""
        return None

    def net_scores(self, images, p):
        """The whole forward in one step: (B,H,W,1) float images ->
        backend-native class scores (B,10), or None to compose the
        stages."""
        return None

    def frame_trunk(self, frames, p):
        """Whole-frame trunk fast path over a (1,H,W,1) frame batch: the
        level-2 role-map quad (I, B, R, C), each (1, H/4, W/4), or None to
        run the composed stages."""
        return None

    def sweep_stage(self, quad, w, b):
        """One stage of the frame sweep's trunk in one step: the role-map
        quad (I, B, R, C), the same tensor four times at level 0, and the
        stage's conv w, b -> the pooled quad, or None to compose the stage
        (`streaming/fcn_sweep._sweep_stage`)."""
        return None

    def window_head(self, maps, gy, gx, p):
        """The frame sweep's head in one step: the four (H/4, W/4) role maps
        and the windows' pooled offsets gy, gx (Nw,) int32 -> (Nw, 10)
        scores with the output activation, or None to compose stack,
        gather, dense and activation."""
        return None


_REGISTRY: dict[str, Backend] = {}


def register_backend(name: str, backend: Backend | None = None):
    """Register a backend instance under `name`, directly or as a class
    decorator (as in the reference)."""
    if backend is not None:
        _REGISTRY[name] = backend
        return backend

    def deco(cls):
        _REGISTRY[name] = cls() if isinstance(cls, type) else cls
        return cls
    return deco


def get_backend(backend: str | Backend) -> Backend:
    if isinstance(backend, Backend):
        return backend
    try:
        return _REGISTRY[backend]
    except KeyError:
        raise KeyError(
            f"unknown backend {backend!r}; registered: {list_backends()}") from None


def list_backends() -> list[str]:
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Float backends: ref / plan, and the float kernels as cuda / cuda_plan
# ---------------------------------------------------------------------------

register_backend("ref", Backend())
register_backend("plan", Backend(name="plan", sigmoid_fn=fxp.sigmoid_plan_f32))


@dataclasses.dataclass(frozen=True)
class CudaFloatBackend(Backend):
    """The float net through the hand-written float kernels (the
    reference's `PallasBackend`).  `activation` selects the activation:
    "sigmoid" (matches `ref`) or "plan" (matches `plan`).  Per served
    step: one whole-net launch (`float_smallnet`) for the images its kernel
    takes.  Per swept frame: one `float_sweep_stage` launch a trunk stage
    (`sweep_stage`), then one `float_window_head` launch (`window_head`).
    Other batches, and the frame sweep's composed cascade, take the
    stages: the conv with the activation as its fused epilogue, the pool,
    the dense product and the matching output activation (the
    `sigmoid_pla` kernel for "plan"); two conv and two pool launches a
    step, and one `sigmoid_pla` launch with "plan"."""
    name: str = "cuda"
    activation: str = "sigmoid"

    def net_scores(self, images, p):
        """The `float_smallnet` kernel's scores for a (B,H,W,1) batch whose
        (H/4)(W/4) pooled map is the dense layer's input, through 2x2
        single-channel convs, and, on the card, whose images the kernel
        takes (`float_smallnet_fits`: 4x4 up to about 170x170); None for any
        other batch, which composes the stages.  A batch the kernel takes
        never composes: a build or launch failure raises."""
        if images.ndim != 4 or images.shape[3] != 1:
            return None
        if any(tuple(p[c]["w"].shape) != (2, 2, 1, 1) or p[c]["b"].numel() != 1
               for c in ("conv1", "conv2")):
            return None
        H, W = images.shape[1:3]
        K, N = p["dense"]["w"].shape
        if (H // 4) * (W // 4) != K or (images.is_cuda and not float_smallnet_fits(H, W, N)):
            return None
        return float_smallnet(images.contiguous(), p["conv1"]["w"], p["conv1"]["b"],
                              p["conv2"]["w"], p["conv2"]["b"], p["dense"]["w"],
                              p["dense"]["b"], activation=self.activation)

    def sweep_stage(self, quad, w, b):
        """The `float_sweep_stage` kernel's pooled quad, each map (1, h/2,
        w/2, 1), for one frame's (1,h,w,1) maps of even extents through a
        2x2 single-channel conv; None for any other, which composes."""
        x = quad[0]
        if (x.ndim != 4 or x.shape[0] != 1 or x.shape[3] != 1 or x.shape[1] < 2
                or x.shape[2] < 2 or x.shape[1] % 2 or x.shape[2] % 2
                or tuple(w.shape) != (2, 2, 1, 1) or b.numel() != 1):
            return None
        out = float_sweep_stage(quad, w, b, activation=self.activation)
        return tuple(m[None, ..., None] for m in out)

    def window_head(self, maps, gy, gx, p):
        # one launch: the features read straight from the maps, the dense
        # layer and the activation (csrc/float_sweep.cu)
        return float_window_head(maps, gy, gx, p["dense"]["w"], p["dense"]["b"],
                                 activation=self.activation)

    def conv2x2_same(self, x, w, b):
        return conv2d(x, w, b, padding="SAME")

    def fused_conv_act(self, x, w, b):
        # the fused epilogue: bias + activation inside the conv kernel
        return conv2d(x, w, b, padding="SAME", activation=self.activation)

    def maxpool2x2(self, x):
        return maxpool2d(x)

    def sigmoid(self, x):
        if self.activation == "plan":
            return sigmoid_pla(x)
        return torch.sigmoid(x)


register_backend("cuda", CudaFloatBackend())
register_backend("cuda_plan", CudaFloatBackend(name="cuda_plan", activation="plan"))


# ---------------------------------------------------------------------------
# Fixed-point backends: the paper's Verilog datapath
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FixedBackend(Backend):
    """Bit-faithful Qm.n two's-complement path (paper §III-B, Fig. 4) in
    PyTorch word ops.  Activations are (B, H, W) int32 words; images are
    quantized at the input port; class scores are int32 words."""
    name: str = "fixed"
    cfg: fxp.FixedPointConfig = fxp.Q16_16

    def quantize_params(self, params):
        """The paper's §III-B weight extraction: float weights -> words."""
        return tree_map(lambda p: fxp.to_fixed(p, self.cfg, device=p.device), params)

    def params_native(self, params) -> bool:
        leaves = tree_leaves(params)
        return bool(leaves) and all(
            not leaf.dtype.is_floating_point and not leaf.dtype.is_complex
            and leaf.dtype != torch.bool for leaf in leaves)

    def ingest(self, images):
        # the paper streams 8-bit pixels via DMA; quantize at the port
        return fxp.to_fixed(images[..., 0], self.cfg).contiguous()   # (B,H,W)

    def conv2x2_same(self, x, w, b):
        # w (2,2,1,1) -> the 4 MAC taps in row-major (dh, dw) order
        return fixed_conv2d_plain(x, w.reshape(4), b, cfg=self.cfg)

    def maxpool2x2(self, x):
        return fixed_maxpool2x2_plain(x)

    def dense(self, x, w, b, scale=None):
        return fixed_dense_plain(x, w, b, cfg=self.cfg)

    def sigmoid(self, x):
        return fxp.fixed_sigmoid_plan(x, self.cfg)

    def accumulate(self, a, b):
        # wraparound fixed add is associative mod 2**total_bits
        return fxp.fixed_add(a, b, self.cfg)

    def _trunk_words(self, x, p):
        return frame_trunk_quad_plain(x, p["conv1"]["w"], p["conv1"]["b"],
                                      p["conv2"]["w"], p["conv2"]["b"], cfg=self.cfg)

    def frame_trunk(self, frames, p):
        # None routes to the composed stages where the trunk cannot tile;
        # the reference's interpret-mode `optimization_barrier` has no
        # counterpart (its hazard is pinned by a test of the corner map)
        B_, H, W = frames.shape[0], frames.shape[1], frames.shape[2]
        if B_ != 1 or H % 4 or W % 4 or H < 4 or W < 4 or self.cfg.saturate:
            return None
        quad = self._trunk_words(self.ingest(frames)[0], p)   # (4, H/4, W/4)
        return tuple(quad[k][None] for k in range(4))


register_backend("fixed", FixedBackend())


@dataclasses.dataclass(frozen=True)
class FixedCudaBackend(FixedBackend):
    """The Qm.n datapath through the CUDA kernels: per served step, one
    whole-net launch (images the kernel takes, 28x28 among them); per swept
    frame, one `frame_trunk` launch and one window-head launch.  Other
    images take two fused conv -> PLAN -> maxpool launches, one dense
    launch and one PLAN sigmoid launch.
    Same words as `fixed` (it reuses its `quantize_params`, `ingest` and
    the `frame_trunk` routing)."""
    name: str = "fixed_cuda"

    def net_scores(self, images, p):
        """The `fixed_smallnet` kernel's scores for a (B,H,W,1) batch whose
        (H/4)(W/4) pooled map is the dense layer's input and, on the card,
        whose images the kernel takes (`smallnet_fits`: 4x4 up to about
        170x170 words); None for any other batch, which composes the
        stages.  A batch the kernel takes never composes: a build or launch
        failure raises."""
        if images.ndim != 4 or images.shape[3] != 1:
            return None
        H, W = images.shape[1:3]
        K, N = p["dense"]["w"].shape
        if (H // 4) * (W // 4) != K or (images.is_cuda and not smallnet_fits(H, W, N)):
            return None
        return fixed_smallnet(self.ingest(images), p["conv1"]["w"], p["conv1"]["b"],
                              p["conv2"]["w"], p["conv2"]["b"], p["dense"]["w"],
                              p["dense"]["b"], cfg=self.cfg)

    def window_head(self, maps, gy, gx, p):
        # one launch: the features read straight from the maps, the dense
        # layer and the PLAN (csrc/fixed_dense.cu)
        return fixed_window_head(maps, gy, gx, p["dense"]["w"], p["dense"]["b"],
                                 cfg=self.cfg)

    def conv2x2_same(self, x, w, b):
        return fixed_conv2d(x, w.reshape(4), b, cfg=self.cfg)

    def fused_conv_act(self, x, w, b):
        return fixed_conv2d(x, w.reshape(4), b, cfg=self.cfg, activation="plan")

    def fused_conv_act_pool(self, x, w, b):
        # windowing -> MAC -> bias -> PLAN -> maxpool, one launch
        return fixed_conv2d(x, w.reshape(4), b, cfg=self.cfg, activation="plan",
                            pool=True)

    def maxpool2x2(self, x):
        return fixed_maxpool2x2(x)

    def dense(self, x, w, b, scale=None):
        return fixed_dense(x, w, b, cfg=self.cfg)

    def sigmoid(self, x):
        return fixed_sigmoid(x, cfg=self.cfg)

    def _trunk_words(self, x, p):
        # one launch of the whole trunk (csrc/frame_trunk.cu)
        return frame_trunk_quad(x, p["conv1"]["w"], p["conv1"]["b"],
                                p["conv2"]["w"], p["conv2"]["b"], cfg=self.cfg)


register_backend("fixed_cuda", FixedCudaBackend())


# ---------------------------------------------------------------------------
# int8 backend: post-training quantization with the quant_matmul kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Int8Backend(Backend):
    """int8 weights: dequant-on-use for the (tiny) convs, a true int8 MAC for
    the dense layer through `kernels/quant_matmul`: activations are
    quantized per tensor on the fly, weights carry per-channel scales, the
    products are summed exactly in int32 and dequantized in the kernel's
    epilogue; the bias is added after it.  One `quant_matmul` launch per
    served step or swept frame."""
    name: str = "int8"
    qcfg: ptq.QuantConfig = ptq.QuantConfig()

    def quantize_params(self, params):
        return ptq.quantize_tree(params, self.qcfg)

    def params_native(self, params) -> bool:
        return any(isinstance(leaf, ptq.QuantTensor) for leaf in tree_leaves(
            params, is_leaf=lambda x: isinstance(x, ptq.QuantTensor)))

    def conv2x2_same(self, x, w, b):
        w = w.dequantize() if isinstance(w, ptq.QuantTensor) else w
        return conv_same_2x2(x, w, b)

    def mask_conv_weight(self, w, mask):
        # conv weights are dequant-on-use anyway, so mask the float view
        # (conv2x2_same passes plain tensors straight through)
        w = w.dequantize() if isinstance(w, ptq.QuantTensor) else w
        return super().mask_conv_weight(w, mask)

    def dense(self, x, w, b, scale=None):
        if not isinstance(w, ptq.QuantTensor):           # float weights
            return x @ w + b
        if scale is None:
            scale = ptq.calibrate_activation_scale(x, self.qcfg)
        xq = ptq.quantize_activation(x, scale, dataclasses.replace(self.qcfg, per_channel=False))
        y = quant_matmul(xq.q, w.q, xq.scale.reshape(()), w.scale.reshape(-1))
        return y + b

    def batch_scale(self, feats):
        # the per-tensor activation scale couples a batch's images: taken
        # over every shard, gathered on the first one's device
        if len(feats) == 1:
            return None
        home = feats[0].device
        return ptq.calibrate_activation_scale(
            torch.cat([self.flatten(f).to(home) for f in feats]), self.qcfg)

    def sigmoid(self, x):
        return fxp.sigmoid_plan_f32(x)


register_backend("int8", Int8Backend())
