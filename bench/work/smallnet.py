"""The work of smallNet's calls, counted from shapes: bytes that a call has
to move at the least and the operations that its arithmetic needs.

Frozen copies of the program's counts (`chip_smoke.py` `smallnet_work`,
`float_smallnet_work`, `window_head_work`, `conv_float_work` and
`analysis/mfu.py` `frame_trunk_work`), so that a later change of the
program cannot move the yardstick; plus the function-level counts that
the per-layer rooflines divide by (`served_step_work`, `sweep_frame_work`),
which count a call's inputs and outputs once whatever kernel runs it.

Bytes: each input word or float read once, each output written once.
Integer operations: 8 a conv word's four taps (4 products, 3 adds, the
bias), 2 a dense multiply-accumulate.  Float operations: 2 a
multiply-accumulate, 1 a bias add, 4 an exact sigmoid, 3 a PLAN word.
"""
from __future__ import annotations

PARAM_WORDS = 2 * (4 + 1) + 49 * 10 + 10          # 510
TRUNK_PARAM_WORDS = 2 * (4 + 1)


def smallnet_work(B: int, H: int, W: int, N: int) -> tuple[int, int]:
    """(bytes, integer operations) of the whole Qm.n net over B (H, W)
    images: four conv words a pooled word at both levels."""
    K = (H // 4) * (W // 4)
    nbytes = 4 * (B * H * W + 10 + K * N + N + B * N)
    return nbytes, B * (8 * 4 * ((H // 2) * (W // 2) + K) + 2 * K * N)


def float_smallnet_work(B: int, H: int, W: int, N: int, act: str) -> tuple[int, int]:
    """(bytes, float operations) of the whole float net over B (H, W)
    images: per conv output 8 for its taps, 1 its bias and the activation's,
    four conv outputs and 3 compares a pooled float; per score 2 a dense
    multiply-accumulate, its bias and its activation."""
    K = (H // 4) * (W // 4)
    a = {"sigmoid": 4, "plan": 3}[act]
    pooled = (H // 2) * (W // 2) + K
    per_image = pooled * (4 * (8 + 1 + a) + 3) + N * (2 * K + 1 + a)
    return 4 * (B * H * W + 10 + K * N + N + B * N), B * per_image


def conv_float_work(B, H, W, cin, kh, kw, cout, Ho, Wo, act) -> tuple[int, int]:
    """(bytes, float operations) of one float conv."""
    nbytes = 4 * (B * H * W * cin + kh * kw * cin * cout + cout + B * Ho * Wo * cout)
    per_out = 2 * kh * kw * cin + 1 + {None: 0, "sigmoid": 4, "plan": 3}[act]
    return nbytes, B * Ho * Wo * cout * per_out


def window_head_work(Nw: int, h: int, w: int, K: int, N: int) -> tuple[int, int]:
    """(bytes, integer operations) of the window head: the four (h, w) role
    maps, the offsets, the dense words read once, the scores written once."""
    return 4 * (4 * h * w + 2 * Nw + K * N + N + Nw * N), 2 * Nw * K * N


def frame_trunk_work(H: int, W: int) -> tuple[int, int]:
    """(bytes, integer operations) that the whole trunk of one (H, W) frame
    needs at the least: 5 bytes (the word in, a quarter word of the four
    pooled maps out) and 18.5 operations a pixel, i.e. 186 + 110 a 4x4
    block (products shared between masked convs once, tap-sum adds, bias
    and recombination adds, PLAN words, pool maxes)."""
    blocks = (H // 4) * (W // 4)
    nbytes = 4 * H * W + 4 * TRUNK_PARAM_WORDS + 4 * 4 * blocks
    return nbytes, (186 + 110) * blocks


def image_ops(dtype: str, H: int = 28, W: int = 28, N: int = 10) -> int:
    """Operations of one image through the whole net in the
    configuration's arithmetic ("int32": Qm.n words; "float32": PLAN)."""
    if dtype == "int32":
        return smallnet_work(1, H, W, N)[1]
    return float_smallnet_work(1, H, W, N, "plan")[1]


def served_step_work(images: int, steps: int, dtype: str,
                     H: int = 28, W: int = 28, N: int = 10) -> tuple[int, int]:
    """(bytes, operations) of `steps` served steps that answered `images`
    real images in all: each real image's pixels read and its scores
    written once, the parameters read once a step; padded slots are not
    work."""
    return (4 * (images * (H * W + N) + steps * PARAM_WORDS),
            images * image_ops(dtype, H, W, N))


def sweep_frame_work(H: int, W: int, n_windows: int,
                     patch: int = 28, N: int = 10) -> tuple[int, int]:
    """(bytes, operations) of one frame's sweep as a function: the frame's
    H*W values read once, the parameters once, each window's N scores
    written once; the trunk's operations (`frame_trunk_work`) and 2 a
    multiply-accumulate of each window's dense layer.  The same count
    stands for the Qm.n and the float arithmetic."""
    K = (patch // 4) ** 2
    nbytes = 4 * (H * W + PARAM_WORDS + n_windows * N)
    return nbytes, frame_trunk_work(H, W)[1] + 2 * n_windows * K * N
