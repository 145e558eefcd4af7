"""The port's attention kernels' plain versions (the CPU path of
``repro_torch.kernels.{flash,decode}_attention``) against the reference's
oracles (``ref.py``) for every case of ``tests/test_kernels_flash.py``, and
against the Pallas kernels in interpret mode for two small cases, plus a
ragged S, lengths of 1 and S_max, and the kernels' zero-row rule; and the
decode kernel's split plan, which the wrapper computes on the host.

Inputs are made with numpy from a seed and fed to both packages; bfloat16
inputs are the same float32 draws rounded to bfloat16 by each framework.
Tolerances are the reference kernel tests': 2e-5 in float32, 2e-2 in
bfloat16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as j_decode
from repro.kernels.decode_attention.ref import decode_attention_ref as j_decode_ref
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_ref
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import flash_attention

torch.set_num_threads(1)

CASES = [
    # B, S, H, KH, Dh, window, softcap (tests/test_kernels_flash.py)
    (2, 256, 4, 2, 64, 0, 0.0),
    (1, 256, 8, 8, 32, 64, 0.0),
    (2, 512, 4, 1, 64, 128, 50.0),
    (1, 128, 4, 4, 128, 0, 30.0),
]
DECODE_CASES = [
    (2, 512, 4, 2, 64, 0, 0.0),
    (3, 1024, 8, 8, 32, 256, 0.0),
    (2, 512, 4, 1, 64, 128, 50.0),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _both(shape, seed, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _qkv(B, S, H, KH, Dh, dtype, seed=0):
    return [_both(shape, seed + i, dtype)
            for i, shape in enumerate(((B, S, H, Dh), (B, S, KH, Dh), (B, S, KH, Dh)))]


def _close(t, j, tol):
    np.testing.assert_allclose(t.to(torch.float32).numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_plain_matches_reference_oracle(case, dtype):
    B, S, H, KH, Dh, window, cap = case
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, S, H, KH, Dh, dtype)
    got = flash_attention(tq, tk, tv, window=window, softcap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, j_flash_ref(jq, jk, jv, window=window, softcap=cap), DTYPES[dtype][2])


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_plain_matches_reference_oracle(case, dtype):
    B, S, H, KH, Dh, window, cap = case
    jq, tq = _both((B, H, Dh), 0, dtype)
    jk, tk = _both((B, S, KH, Dh), 1, dtype)
    jv, tv = _both((B, S, KH, Dh), 2, dtype)
    lens = np.array([max(1, S // (i + 2)) for i in range(B)], np.int32)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lens), window=window, softcap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = j_decode_ref(jq, jk, jv, jnp.asarray(lens), window=window, softcap=cap)
    _close(got, want, DTYPES[dtype][2])


def test_flash_plain_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode, the reference tests' tiles)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 128, 4, 2, 32, "float32", seed=5)
    want = j_flash(jq, jk, jv, window=40, softcap=20.0, block_q=64, block_k=64)
    _close(flash_attention(tq, tk, tv, window=40, softcap=20.0), want, 2e-5)


def test_decode_plain_matches_pallas_interpret_with_an_empty_sequence():
    """lengths 0, 1 and S_max through the Pallas kernel: an empty sequence
    gives zeros there (the kernel's max(l, 1e-30) rule), and here."""
    jq, tq = _both((3, 4, 32), 7, "float32")
    jk, tk = _both((3, 128, 2, 32), 8, "float32")
    jv, tv = _both((3, 128, 2, 32), 9, "float32")
    lens = np.array([0, 1, 128], np.int32)
    want = j_decode(jq, jk, jv, jnp.asarray(lens), block_s=64)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lens))
    _close(got, want, 2e-5)
    assert (got[0] == 0).all()


@pytest.mark.parametrize("window,cap", [(0, 0.0), (9, 0.0), (0, 25.0)])
def test_flash_ragged_sequence_length(window, cap):
    """S = 77 is no multiple of any tile (the TPU wrapper asserts one)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 77, 6, 3, 16, "float32", seed=11)
    got = flash_attention(tq, tk, tv, window=window, softcap=cap)
    _close(got, j_flash_ref(jq, jk, jv, window=window, softcap=cap), 2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_lengths_one_and_full(dtype):
    jq, tq = _both((2, 8, 64), 3, dtype)
    jk, tk = _both((2, 200, 4, 64), 4, dtype)
    jv, tv = _both((2, 200, 4, 64), 5, dtype)
    lens = np.array([1, 200], np.int32)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lens), window=16)
    want = j_decode_ref(jq, jk, jv, jnp.asarray(lens), window=16)
    _close(got, want, DTYPES[dtype][2])
    # length 1 attends to row 0 alone: the output is v[0] of its KV head
    _close(got[0], jnp.repeat(jv[0, 0], 2, axis=0), DTYPES[dtype][2])


def test_zero_row_rule_where_the_reference_oracle_gives_nan():
    """A row with no valid key: zeros from the plain version (the kernel's
    rule), NaN from the reference's oracle."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 5, 2, 2, 16, "float32", seed=17)
    # a negative length leaves a decode row no key
    lens = np.array([-1], np.int32)
    got = dk.decode_attention_plain(tq[:, 0], tk, tv, torch.from_numpy(lens))
    assert (got == 0).all()
    assert np.isnan(np.asarray(j_decode_ref(jq[:, 0], jk, jv, jnp.asarray(lens)))).all()
    # non-causal with a window of 1 leaves every prefill row one key
    _close(fk.flash_attention_plain(tq, tk, tv, causal=False, window=1),
           j_flash_ref(jq, jk, jv, causal=False, window=1), 2e-5)


def test_plain_versions_take_an_explicit_scale():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 64, 4, 2, 32, "float32", seed=13)
    _close(flash_attention(tq, tk, tv, window=20, softcap=10.0, scale=0.3),
           j_flash_ref(jq, jk, jv, window=20, softcap=10.0, scale=0.3), 2e-5)
    lens = np.array([64, 30], np.int32)
    _close(decode_attention(tq[:, -1], tk, tv, torch.from_numpy(lens), window=8, scale=0.3),
           j_decode_ref(jq[:, -1], jk, jv, jnp.asarray(lens), window=8, scale=0.3), 2e-5)


def test_decode_matches_flash_last_row():
    """Decode over a filled cache == the last row of causal prefill."""
    q, k, v = (torch.from_numpy(np.random.default_rng(i).standard_normal(s).astype(np.float32))
               for i, s in enumerate(((2, 96, 4, 32), (2, 96, 2, 32), (2, 96, 2, 32))))
    full = flash_attention(q, k, v)
    dec = decode_attention(q[:, -1], k, v, torch.tensor([96, 96], dtype=torch.int32))
    torch.testing.assert_close(full[:, -1], dec, atol=2e-5, rtol=2e-5)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.randn(1, 8, 2, 16) for _ in range(3))
    f0, d0 = fk.launches, dk.launches
    flash_attention(q, k, v)
    decode_attention(q[:, 0], k, v, torch.tensor([3], dtype=torch.int32))
    assert (fk.launches, dk.launches) == (f0, d0)
    assert not fk.LIB.loaded and not dk.LIB.loaded


def test_wrappers_refuse_malformed_inputs():
    q, k, v = (torch.randn(1, 8, 4, 16) for _ in range(3))
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :3], v[:, :, :3])  # 4 heads over 3 KV heads
    with pytest.raises(ValueError):
        decode_attention(q[:, 0], k, v, torch.tensor([1, 2], dtype=torch.int32))


SPLIT_SHAPES = [
    # B, KH, S
    (4, 16, 256),  # the engine's decode
    (4, 16, 8192),  # the long cache of chip_smoke.py's time line
    (1, 2, 8192),
    (1, 1, 1),
    (2, 8, 300),  # ragged: no multiple of the tile
    (4, 16, 1 << 20),  # more tiles than splits allowed
]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_plan_covers_the_cache_in_whole_tiles(shape, dtype):
    """Splits are runs of whole tiles that cover [0, S), none of them empty:
    every split starts below S, and the last one reaches it."""
    B, KH, S = shape
    for Dh in dk.HEAD_DIMS:
        ns, rows = dk.split_plan(B, KH, S, Dh, dtype)
        assert 1 <= ns <= dk.MAX_SPLITS and rows > 0 and rows % dk.BLOCK_S == 0
        assert (ns - 1) * rows < S <= ns * rows
        assert dk.num_splits(B, KH, S, Dh, dtype) == ns


def test_split_plan_keeps_short_caches_whole_and_fills_the_card_on_long_ones():
    bf16 = torch.bfloat16
    assert dk.num_splits(4, 16, 256, 64, bf16) == 1  # the engine's shape: one pass
    ns = dk.num_splits(4, 16, 8192, 64, bf16)
    assert 1.5 * dk.SMS <= 4 * 16 * ns <= 3 * dk.SMS  # about twice over
    assert dk.launch_grid(4, 16, 16, 8192, 64, bf16) == ((4 * 16, ns), dk.THREADS)
    # a group of 12 query heads per KV head takes two head chunks of 8
    assert dk.launch_grid(2, 24, 2, 256, 64, bf16) == ((2 * 2 * 2, 1), dk.THREADS)


WIDE_CASES = [
    # B, S, H, KH, window, softcap: zamba2's G = 1, gemma3's G = 2 (windowed), G = 4
    (1, 70, 4, 4, 0, 0.0),
    (2, 45, 4, 2, 16, 0.0),
    (1, 33, 8, 2, 0, 30.0),
]


@pytest.mark.parametrize("case", WIDE_CASES)
@pytest.mark.parametrize("Dh", [224, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_heads_plain_match_reference_oracles(case, Dh, dtype):
    """The head widths 224 (zamba2-7b's shared attention) and 256
    (gemma3-4b): prefill and decode (lengths 1 and full, ragged S) against
    the reference's oracles."""
    B, S, H, KH, window, cap = case
    tol = DTYPES[dtype][2]
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, S, H, KH, Dh, dtype, seed=Dh)
    got = flash_attention(tq, tk, tv, window=window, softcap=cap)
    _close(got, j_flash_ref(jq, jk, jv, window=window, softcap=cap), tol)
    lens = np.array([1, S][:B] if B > 1 else [S], np.int32)
    got = decode_attention(tq[:, -1], tk, tv, torch.from_numpy(lens), window=window,
                           softcap=cap)
    want = j_decode_ref(jq[:, -1], jk, jv, jnp.asarray(lens), window=window, softcap=cap)
    _close(got, want, tol)


@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0), (True, 20, 10.0),
                                                   (False, 7, 0.0)])
def test_plain_flash_over_query_blocks_matches_the_oracle(monkeypatch, causal, window,
                                                          softcap):
    """``flash_attention_plain`` walks blocks of ``PLAIN_BLOCK_Q`` query
    rows: cut to 16-row blocks, a ragged S of 72 (four whole blocks and one
    of 8) gives the reference oracle's rows and the one-block run's
    log-sum-exp."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 72, 4, 2, 32, "float32", seed=23)
    kw = dict(causal=causal, window=window, softcap=softcap)
    whole, whole_lse = fk.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    monkeypatch.setattr(fk, "PLAIN_BLOCK_Q", 16)
    got, lse = fk.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    _close(got, j_flash_ref(jq, jk, jv, **kw), 2e-5)
    np.testing.assert_allclose(lse.numpy(), whole_lse.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
    meta = flash_attention(*(t.to("meta") for t in (tq, tk, tv)), **kw)
    assert meta.is_meta and meta.shape == got.shape and meta.dtype == got.dtype
