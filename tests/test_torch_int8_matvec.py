"""K6 (``csrc/int8_matvec.cu``, ``dequant_matvec``) on the CPU.

- :func:`dequant_matvec_plan` tiles every (b, t, d) output exactly once at
  the shapes ``chip_smoke.py`` phase 10 checks and at the camera's full
  width, covers C's rows with whole stages, keeps a block's shared memory
  within the card's 227 KB for C up to 2048 and groups of 4 batch rows, and
  sends D % 16 != 0 (or a misaligned w8) to the byte-wise path.
- The kernel's dequantization, emulated in numpy: the byte of ``w ^
  0x80808080`` under the exponent of 2^23, less 2^23 + 128, is the int8
  value exactly, and its float32's top half is the exact bf16 of it; one
  round to nearest even of the exact product q * s (what ``fma.rn.bf16x2``
  with a -0 addend computes) equals the plain version's bf16 weight.
- The plain version's bf16 mode equals the JAX package's bf16
  dequantization ``w8.astype(bf16) * scale[:, None, :]`` (``models/rtm.py``
  line 324) bit for bit, over every int8 value and seeded sweeps of normal
  bf16 scales (JAX is imported in the test only); subnormal scales, which
  XLA's CPU backend reads as zero, the port multiplies as numbers.

The kernel itself runs on the card only: ``chip_smoke.py`` phase 10 (and
the ``cuda``-marked test here, which skips without a card).
"""

import numpy as np
import pytest
import torch

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import cuda_kernels as ck
from _torch_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
# [B, T, C, D]: chip_smoke.py phase 10's four (the camera's full width, the
# rtm_trunc5_attn fold and its mlp_q8 layer, the byte-wise path), a batch of
# 4 at full width, and ragged shapes of the bf16 card test
PLAN_SHAPES = [(1, 12, 2048, 2048), (2, 3, 256, 256), (2, 3, 256, 32), (5, 3, 40, 24),
               (4, 12, 2048, 2048), (3, 5, 33, 17), (9, 3, 128, 64)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_tiles_every_output_once(shape):
    """Each block covers tile_cols columns of one task for one group of
    batch rows (masked past D and B), as the kernel indexes its grid."""
    b, t, c, d = shape
    plan = ck.dequant_matvec_plan(b, t, c, d)
    hits = np.zeros((b, t, d), np.int32)
    gx, gt, gz = plan.grid
    assert gt == t
    for z in range(gz):
        for x in range(gx):
            d0, b0 = x * plan.tile_cols, z * plan.group
            hits[b0:b0 + plan.group, :, d0:d0 + plan.tile_cols] += 1
    np.testing.assert_array_equal(hits, 1)
    # C's rows: whole stages of rows_per_stage that cover it, none spare
    assert (plan.k_steps - 1) * plan.rows_per_stage < c <= plan.k_steps * plan.rows_per_stage
    assert plan.group == (1 if b == 1 else 4)


def test_plan_at_the_camera_shape():
    """384 blocks (three an SM of 132) on the ring of 16-byte copies."""
    plan = ck.dequant_matvec_plan(1, 12, 2048, 2048)
    assert plan.grid == (32, 12, 1) and plan.vec16 and plan.stages == ck.DEQUANT_STAGES >= 3
    assert plan.smem == 4 * 4096 + 4 * (2048 + 8 * 64)


@pytest.mark.parametrize("c", [1, 40, 64, 65, 256, 2047, 2048])
@pytest.mark.parametrize("b", [1, 4, 9])
def test_plan_shared_memory_fits(b, c):
    """The ring, x's rows (zero-padded to whole stages, one group) and the
    per-warp column sums stay within a block's 227 KB."""
    plan = ck.dequant_matvec_plan(b, 12, c, 2048)
    ring = plan.stages * plan.rows_per_stage * plan.tile_cols
    x_rows = 4 * plan.group * plan.k_steps * plan.rows_per_stage
    assert plan.smem == ring + x_rows + 4 * 8 * plan.tile_cols
    assert plan.smem <= 227 * 1024


@pytest.mark.parametrize("d,aligned,vec16", [(24, True, False), (17, True, False), (2040, True, False),
                                             (32, True, True), (2048, True, True), (2048, False, False)])
def test_plan_sends_ragged_columns_to_the_byte_wise_path(d, aligned, vec16):
    plan = ck.dequant_matvec_plan(2, 3, 256, d, aligned)
    assert plan.vec16 == vec16 and plan.stages == (ck.DEQUANT_STAGES if vec16 else 0)


def test_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="beyond the kernel"):
        ck.dequant_matvec_plan(4, 3, 64 * 1024, 64)  # x's rows alone exceed 227 KB


def _q_by_magic(word: np.ndarray) -> np.ndarray:
    """The kernel's dequantization of uint32 words of four int8 weights:
    u = w ^ 0x80808080; byte e of u under 0x4B000000, as a float32, less
    8388736 -> [n, 4] float32, in byte order."""
    u = word ^ np.uint32(0x80808080)
    parts = [((u >> np.uint32(8 * e)) & np.uint32(0xFF)) | np.uint32(0x4B000000) for e in range(4)]
    return np.stack([p.view(np.float32) - np.float32(8388736.0) for p in parts], axis=-1)


def test_magic_dequantization_is_exact():
    """Every int8 value in every byte position comes back exactly, and the
    top half of its float32 is its exact bf16 (the kernel's pair packing)."""
    q = np.arange(-128, 128, dtype=np.int8)
    for shift in range(4):
        words = np.roll(np.stack([q, q[::-1], np.roll(q, 7), np.roll(q, 100)], axis=-1), shift, axis=-1)
        got = _q_by_magic(np.ascontiguousarray(words).view(np.uint32).ravel())
        np.testing.assert_array_equal(got, words.astype(np.float32))
    f = q.astype(np.float32)
    assert not (f.view(np.uint32) & np.uint32(0xFFFF)).any()
    top = torch.from_numpy((f.view(np.uint32) >> np.uint32(16)).astype(np.int16)).view(BF16)
    torch.testing.assert_close(top.float(), torch.from_numpy(f), atol=0, rtol=0)


def _bf16_scales(kind: str, n: int = 4096) -> torch.Tensor:
    """Seeded bf16 scales of both signs: ``normal`` around a fold's scales,
    ``wide`` over every normal exponent whose product with 128 stays
    finite, ``subnormal`` the subnormals and zeros."""
    rng = np.random.RandomState({"normal": 1, "subnormal": 2, "wide": 3}[kind])
    lo, hi = {"normal": (100, 140), "subnormal": (0, 1), "wide": (1, 248)}[kind]
    bits = (rng.randint(0, 2, n) << 15) | (rng.randint(lo, hi, n) << 7) | rng.randint(0, 128, n)
    return torch.from_numpy(bits.astype(np.int16)).view(BF16)


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """float64 values exact in float32 rounded once to bf16, nearest even."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16
    return (b.astype(np.uint32) << np.uint32(16)).view(np.float32)


@pytest.mark.parametrize("kind", ["normal", "subnormal", "wide"])
def test_bf16_weight_rounds_the_exact_product_once(kind):
    """q * s is exact in float32 (8 x 8 significant bits), so one
    round-to-nearest-even of it (the kernel's fma.rn.bf16x2 with a -0
    addend) is the plain version's bf16 weight, over every int8 value."""
    s = _bf16_scales(kind)
    q = torch.arange(-128, 128, dtype=torch.int8)
    want = (q.to(BF16)[:, None] * s[None, :]).float().numpy()
    exact = q.numpy().astype(np.float64)[:, None] * s.float().numpy().astype(np.float64)[None, :]
    assert np.array_equal(exact.astype(np.float32).astype(np.float64), exact)
    np.testing.assert_array_equal(_round_bf16(exact), want)


def _plain_and_jax_weights(kind: str):
    """Every int8 value x 1,024 seeded bf16 scales, dequantized by the plain
    version's bf16 mode (one-hot x picks each weight alone) and by the JAX
    package's bf16 fold product ``w8.astype(bf16) * scale[:, None, :]``."""
    import jax.numpy as jnp

    s = _bf16_scales(kind, 1024)
    w8 = np.broadcast_to(np.arange(-128, 128, dtype=np.int8)[None, :, None], (1, 256, s.numel())).copy()
    scale = s[None, :]
    jax_w = np.asarray((jnp.asarray(w8).astype(jnp.bfloat16)
                        * jnp.asarray(scale.float().numpy()).astype(jnp.bfloat16)[:, None, :]
                        ).astype(jnp.float32))[0]
    x = torch.eye(256, dtype=BF16)[:, None, :]
    got = ck.dequant_matvec(x, torch.from_numpy(w8), scale)  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (256, 1, s.numel())
    exact = np.arange(-128, 128, dtype=np.float64)[:, None] * s.float().numpy().astype(np.float64)[None, :]
    return got[:, 0].numpy(), jax_w, exact


@pytest.mark.parametrize("kind", ["normal", "wide"])
def test_plain_bf16_equals_jax_dequantization_bit_for_bit(kind):
    """With normal scales (every product normal or zero) the plain
    version's bf16 weights are the JAX package's, bit for bit."""
    got, jax_w, _ = _plain_and_jax_weights(kind)
    np.testing.assert_array_equal(got, jax_w)


def test_subnormal_scales_jax_cpu_reads_zero_and_the_port_keeps():
    """Subnormal scales: XLA's CPU backend reads a subnormal bf16 operand as
    zero, so the JAX expression gives +-0 for every weight; the plain
    version (and the kernel, held to it bit for bit by chip_smoke.py's
    exhaustive phase) rounds the exact product once, as for every other
    scale.  (A fold's scales, max|w| / 127, are normal.)"""
    got, jax_w, exact = _plain_and_jax_weights("subnormal")
    np.testing.assert_array_equal(got, _round_bf16(exact))
    assert (got != 0).mean() > 0.9 and (jax_w == 0).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 has no CPU mode (run chip_smoke.py there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_kernel_matches_plain_on_card(shape, bf16, cuda_device):
    """K6 within 1e-4 x max|y| of its plain version, one launch a call, two
    calls bit-identical."""
    b, t, c, d = shape
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(b, t, c).astype(np.float32)).to(cuda_device)
    w8 = torch.from_numpy(rng.randint(-127, 128, (t, c, d)).astype(np.int8)).to(cuda_device)
    scale = torch.from_numpy((rng.rand(t, d).astype(np.float32) + 0.5) * 1e-3).to(cuda_device)
    if bf16:
        x, scale = x.to(BF16), scale.to(BF16)
    ck.reset_launches()
    got = ck.dequant_matvec(x, w8, scale)
    again = ck.dequant_matvec(x, w8, scale)
    assert ck.LAUNCHES["dequant_matvec"] == 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = ck.dequant_matvec_plain(x, w8, scale)
    torch.testing.assert_close(got, want, atol=1e-4 * float(want.abs().max()), rtol=0)
