"""Mamba2 SSD chunked scan: the CUDA launch wrapper and its plain version.

The scan takes x [B, S, H, P], Bm/Cm [B, S, G, N] (head h reads group
h // (H // G); G = H is the reference's layout, G = ngroups the model's
unrepeated one), dt [B, S, H] (float32, post-softplus, >= 0), A [H] (< 0)
and D [H] (float32). It starts from a zero state and, chunk by chunk of
L = min(chunk, S) steps, with cs = cumsum(dt * A) inside the chunk, returns

    y[l]  = exp(cs[l]) C[l] . state + sum_{s <= l} (C[l] . B[s]) exp(cs[l] - cs[s]) dt[s] x[s]
            + D x[l]
    state <- state exp(cs[L-1]) + sum_s exp(cs[L-1] - cs[s]) dt[s] x[s] (x) B[s]

all in float32: y in x's dtype, the final state [B, H, P, N] in float32. A
last partial chunk acts as if zero-padded with dt = 0 (the reference model's
rule): padded steps neither decay nor write the state.

``ops.ssd_scan`` picks by the tensor's device: a CUDA tensor launches
``ssd_scan_cuda`` (the Hopper kernel built from ``csrc/ssd_scan.cu``), a CPU
tensor takes ``ssd_scan_plain``. The source is compiled on first use by
``repro_torch.kernels.build``; nothing is built when the module is imported.

The kernel runs the chunks in parallel (``plan`` says how): one launch when
the sequence is one chunk, else three (each chunk's own state, the state
passed across chunks in a float32 workspace, the outputs).

The gradient. ``SsdScanFn`` is the kernel under autograd: its forward
launches ``ssd_scan_cuda`` and keeps the inputs, its backward launches
``ssd_scan_bwd_cuda``, the six kernels of ``csrc/ssd_scan_bwd.cu`` (tensor
cores with bf16 operand parts, a block per slice of a group's heads, no
atomics, so a gradient is the same bits every run; the library's
``ssd_scan_bwd_plan`` says how a call runs). ``ssd_scan_bwd_plain`` is their plain version, ``bwd_phases`` in
float32, phase for phase. The reference has no such kernel: it trains
through its jnp scan, which XLA differentiates.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import CudaLibrary, require_sm90

HEAD_DIMS = (16, 32, 64, 128)  # the head widths P the CUDA kernel is built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ERR_SHARED_MEMORY = -1  # the launcher's code for a block that does not fit shared memory

launches = 0  # CUDA launches of this kernel (one per wrapper call on a CUDA tensor)
bwd_launches = 0  # CUDA kernels the backward launched (BWD_KERNELS per backward call)
BWD_KERNELS = 6  # chunk sums, state pass, rows, columns, dt, reductions
BWD_MAX_N = 256  # the largest state width N the backward is built for


def reset_launches() -> None:
    global launches, bwd_launches
    launches = 0
    bwd_launches = 0


MIN_BLOCKS = 128  # output blocks one chunk should give at least (the card has 132 SMs)


def state_cols(warps: int) -> int:
    """State columns per state block (the source's ``state_cols``): 4 n8
    tiles per warp."""
    return 32 * warps


class Plan(NamedTuple):
    """How one call runs: ``chunks`` of ``L`` steps; ``warps`` of 16 query
    rows per output block; P cut into slices of ``p_slice``; the grid of
    output blocks (b, chunk, head) x ``q_tiles`` x slices and of state blocks
    (b, chunk, head) x ``col_groups`` x slices; ``kernels`` CUDA launches;
    ``workspace`` bytes (each chunk's own state and decay in float32, then
    its starting state in bf16 parts)."""
    L: int
    chunks: int
    warps: int
    p_slice: int
    q_tiles: int
    col_groups: int
    out_blocks: int
    state_blocks: int
    kernels: int
    workspace: int


def _parts(dtype: torch.dtype) -> tuple:
    """bf16 parts of an input and of a float32 operand, as the kernel splits
    them: float32 inputs 3 and 3, bfloat16 inputs 1 (exact) and 2."""
    return (3, 3) if dtype == torch.float32 else (1, 2)


def workspace_bytes(dtype: torch.dtype, B: int, S: int, H: int, P: int, N: int,
                    L: int) -> int:
    """The source's ``ssd_scan_workspace_bytes``: per (b, chunk, head) a
    float32 [P, N] contribution and a decay, then (16-byte aligned) the
    starting state as bf16 parts."""
    bch = B * -(-S // L) * H
    start = -(-(4 * bch * (P * N + 1)) // 16) * 16
    return start + 2 * bch * _parts(dtype)[1] * P * N


@functools.lru_cache(maxsize=256)
def plan(B: int, S: int, H: int, P: int, N: int, chunk: int,
         dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The kernel's launch plan, from the shapes alone. Output blocks take
    16 query rows per warp, 2 warps when the chunk is at most 32 steps (the
    engine's 32-token prefill) and 4 otherwise; P-slices are at most 64 wide,
    and a single chunk cuts them down to 16 until at least ``MIN_BLOCKS``
    output blocks run."""
    L = min(chunk, S)
    nc = -(-S // L)
    warps = 2 if L <= 32 else 4
    q_tiles = -(-L // (16 * warps))
    col_groups = -(-(-(-N // 16) * 16) // state_cols(warps))
    ps = min(P, 64)
    while nc == 1 and ps > 16 and q_tiles * B * H * (P // ps) < MIN_BLOCKS:
        ps //= 2
    bch = B * nc * H
    return Plan(L=L, chunks=nc, warps=warps, p_slice=ps, q_tiles=q_tiles,
                col_groups=col_groups, out_blocks=bch * q_tiles * (P // ps),
                state_blocks=bch * col_groups * (P // ps), kernels=1 if nc == 1 else 3,
                workspace=0 if nc == 1 else workspace_bytes(dtype, B, S, H, P, N, L))


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.ssd_scan_workspace_bytes
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong


def _declare_bwd(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.ssd_scan_bwd_workspace_bytes
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    fn = lib.ssd_scan_bwd_plan
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


_CSRC = Path(__file__).resolve().parent / "csrc"
LIB = CudaLibrary(_CSRC / "ssd_scan.cu", _declare)
LIB_BWD = CudaLibrary(_CSRC / "ssd_scan_bwd.cu", _declare_bwd)


def _check(x, Bm, Cm, dt, A, D, chunk) -> None:
    if x.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape or dt.dim() != 3:
        raise ValueError(f"shapes: x {tuple(x.shape)}, Bm {tuple(Bm.shape)}, "
                         f"Cm {tuple(Cm.shape)}, dt {tuple(dt.shape)}")
    B, S, H, _ = x.shape
    G = Bm.shape[2]
    if (Bm.shape[:2] != (B, S) or G < 1 or H % G or tuple(dt.shape) != (B, S, H)
            or tuple(A.shape) != (H,) or tuple(D.shape) != (H,)):
        raise ValueError(f"shapes: x {tuple(x.shape)}, Bm/Cm {tuple(Bm.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, D {tuple(D.shape)}")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"dtypes: x {x.dtype}, Bm {Bm.dtype}, Cm {Cm.dtype} "
                        "(one of float32/bfloat16)")
    if len({t.device for t in (x, Bm, Cm, dt, A, D)}) != 1:
        raise ValueError(f"devices differ: {[str(t.device) for t in (x, Bm, Cm, dt, A, D)]}")
    if chunk < 1 or S < 1:
        raise ValueError(f"chunk {chunk} and sequence length {S} must be >= 1")


def ssd_scan_plain(x, Bm, Cm, dt, A, D, *, chunk: int = 128):
    """Plain PyTorch version of the kernel: the reference model's
    ``_ssd_chunk_scan`` (zero-padded to whole chunks, a loop over chunks,
    float32 einsums), with groups repeated to heads and the decay masked
    before its exp rather than after (the same values; a gradient that stays
    finite where a long chunk's exp would overflow above the diagonal). Same
    signature and result as the kernel."""
    _check(x, Bm, Cm, dt, A, D, chunk)
    f32 = torch.float32
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    rep = H // Bm.shape[2]
    xf, Bf, Cf = x.to(f32), Bm.to(f32), Cm.to(f32)
    if rep > 1:
        Bf = Bf.repeat_interleave(rep, dim=2, output_size=H)
        Cf = Cf.repeat_interleave(rep, dim=2, output_size=H)
    dtf, A, D = dt.to(f32), A.to(f32), D.to(f32)
    L = min(chunk, S)
    pad = (-S) % L
    if pad:  # dt = 0 makes padded steps identity (no decay, no state write)
        xf, Bf, Cf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, Bf, Cf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
    tril = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
    ys = []
    for c0 in range(0, S + pad, L):
        x_c, B_c, C_c, dt_c = (t[:, c0:c0 + L] for t in (xf, Bf, Cf, dtf))
        cs = torch.cumsum(dt_c * A, dim=1)  # [B, L, H], <= 0
        y_off = torch.einsum("blhn,bhpn->blhp", C_c, h) * torch.exp(cs)[..., None]
        # masked above the diagonal before the exp, where cs[l] - cs[s] > 0
        # could overflow (and make autograd's gradient inf * 0)
        diff = cs[:, :, None, :] - cs[:, None, :, :]  # [B, l, s, H]
        decay = torch.exp(torch.where(tril[None, :, :, None], diff, float("-inf")))
        scores = torch.einsum("blhn,bshn->blsh", C_c, B_c) * decay * dt_c[:, None, :, :]
        y_diag = torch.einsum("blsh,bshp->blhp", scores, x_c)
        last = cs[:, -1, :]  # [B, H]
        sdecay = torch.exp(last[:, None, :] - cs) * dt_c  # [B, L, H]
        h = h * torch.exp(last)[:, :, None, None] + torch.einsum(
            "blhn,blhp,blh->bhpn", B_c, x_c, sdecay)
        ys.append(y_off + y_diag + D[None, None, :, None] * x_c)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(x.dtype), h


def bwd_phases(x, Bm, Cm, dt, A, D, dy, dstate, chunk, f=torch.float32):
    """The backward's chunk-parallel phases, as the CUDA kernels run them,
    with every sum in dtype ``f``; returns (dx [B,S,H,P], dBm, dCm [B,S,G,N],
    ddt [B,S,H], dA, dD [H]) in ``f``. Per (b, chunk c, head), with w[s] =
    exp(cs[last] - cs[s]) dt[s] and G_c the gradient of the state that
    enters chunk c:
      (a) S_c, each chunk's starting state (the forward's state pass);
      (b) local_c = sum_l exp(cs[l]) dy[l] (x) C[l];
      (c) G_c = local_c + exp(cs[last]) G_{c+1}, from G_nc = dstate;
      (d) dx = scores^T dy + D dy + w (G_{c+1} B), dC and dB from the
          scores' gradient (dy . x) decay dt, S_c and G_{c+1}; each step's
          d(cs) from y_off, the scores (rows minus columns), w and, at the
          last step, exp(cs[last]) <G_{c+1}, S_c> + sum_s w[s] (x . G B)[s];
          ddt = its direct terms + A revcumsum(d(cs)), partial dA and dD;
      (e) dB and dC summed over a group's heads, dA and dD over (b, c).
    Padded steps of a ragged last chunk have dt = 0 and are dropped."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S

    def chunks(t, heads_of_groups=False):
        t = F.pad(t.to(f), (0, 0) * (t.dim() - 2) + (0, pad))
        if heads_of_groups:
            t = t.repeat_interleave(rep, dim=2)
        return t.reshape(Bsz, nc, L, *t.shape[2:])

    xc, dyc, dtc = chunks(x), chunks(dy), chunks(dt)
    Bh, Ch = chunks(Bm, True), chunks(Cm, True)  # [B, nc, L, H, N]
    A, D = A.to(f), D.to(f)
    cs = torch.cumsum(dtc * A, dim=2)  # [B, nc, L, H]
    last = cs[:, :, -1]  # padded steps have dt = 0: the last live step's cs
    ecs = torch.exp(cs)
    w = torch.exp(last[:, :, None] - cs) * dtc
    # (a) starting states
    own = torch.einsum("bclh,bclhp,bclhn->bchpn", w, xc, Bh)
    st = torch.zeros((Bsz, H, P, N), dtype=f, device=x.device)
    starts = []
    for c in range(nc):
        starts.append(st)
        st = st * torch.exp(last[:, c])[:, :, None, None] + own[:, c]
    Sc = torch.stack(starts, dim=1)  # [B, nc, H, P, N]
    # (b) each chunk's own state gradient, (c) the reverse pass
    local = torch.einsum("bclh,bclhp,bclhn->bchpn", ecs, dyc, Ch)
    g = (torch.zeros((Bsz, H, P, N), dtype=f, device=x.device) if dstate is None
         else dstate.to(f))
    nexts = [None] * nc
    for c in reversed(range(nc)):
        nexts[c] = g
        g = local[:, c] + torch.exp(last[:, c])[:, :, None, None] * g
    Gn = torch.stack(nexts, dim=1)  # G_{c+1}: [B, nc, H, P, N]
    # (d) the blocks: [l, s] tiles masked to s <= l before the exp
    tril = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # [B, nc, l, s, H]
    decay = torch.exp(torch.where(tril, diff, float("-inf")))
    cb = torch.einsum("bclhn,bcshn->bclsh", Ch, Bh)
    dyx = torch.einsum("bclhp,bcshp->bclsh", dyc, xc)
    dts = dtc[:, :, None]  # dt[s]
    m = dyx * cb * decay  # d(scores) / d(dt[s])
    z = m * dts  # d(scores) . scores
    dcb = dyx * decay * dts
    u = torch.einsum("bchpn,bcshn->bcshp", Gn, Bh)  # G_{c+1} B[s]
    q = (xc * u).sum(-1)  # x[s] . G_{c+1} B[s]
    v = torch.einsum("bclhp,bchpn->bclhn", dyc, Sc)  # dy[l] S_c
    dx = (torch.einsum("bclsh,bclhp->bcshp", cb * decay * dts, dyc)
          + D[:, None] * dyc + w[..., None] * u)
    dC = ecs[..., None] * v + torch.einsum("bclsh,bcshn->bclhn", dcb, Bh)
    dB = (torch.einsum("bclsh,bclhn->bcshn", dcb, Ch)
          + w[..., None] * torch.einsum("bcshp,bchpn->bcshn", xc, Gn))
    dcs = (ecs * (Ch * v).sum(-1)) + z.sum(3) - z.sum(2) - w * q
    dcs[:, :, -1] += torch.exp(last) * (Gn * Sc).sum((-1, -2)) + (w * q).sum(2)
    rev = torch.flip(torch.cumsum(torch.flip(dcs, [2]), dim=2), [2])
    ddt = m.sum(2) + torch.exp(last[:, :, None] - cs) * q + A * rev
    dA_part = (dtc * rev).sum(2)  # [B, nc, H]
    dD_part = (dyc * xc).sum((2, 4))
    # (e) fixed-order reductions; undo the padding
    unpad = lambda t: t.reshape(Bsz, nc * L, *t.shape[3:])[:, :S]  # noqa: E731
    dB, dC = (unpad(t).reshape(Bsz, S, G, rep, N).sum(3) for t in (dB, dC))
    return (unpad(dx), dB, dC, unpad(ddt), dA_part.sum((0, 1)), dD_part.sum((0, 1)))


def ssd_scan_bwd_plain(x, Bm, Cm, dt, A, D, dy, dstate=None, *, chunk: int = 128):
    """Plain PyTorch version of the backward kernels: ``bwd_phases`` in
    float32. ``dy`` is y's gradient [B, S, H, P], ``dstate`` the final
    state's [B, H, P, N] (None: zero, as in training, where the state is
    dropped). Returns (dx, dBm, dCm, ddt, dA, dD): dx in x's dtype, dBm and
    dCm [B, S, G, N] in Bm's (each summed over its group's heads), ddt, dA
    and dD float32."""
    _check(x, Bm, Cm, dt, A, D, chunk)
    dx, dB, dC, ddt, dA, dD = bwd_phases(x, Bm, Cm, dt, A, D, dy, dstate, chunk)
    return dx.to(x.dtype), dB.to(Bm.dtype), dC.to(Cm.dtype), ddt, dA, dD


def ssd_scan_cuda(x, Bm, Cm, dt, A, D, *, chunk: int = 128):  # repro: device-region static[chunk]
    """Launch the Hopper kernel on the current stream (no synchronisation).
    Raises, launching nothing, on what it does not take: another device
    than an sm_90 card, x/Bm/Cm not all float32 or all bfloat16, dt/A/D
    not float32, non-contiguous tensors, a head width outside
    ``HEAD_DIMS`` (``ValueError``/``TypeError``), or an (N, chunk) whose
    tiles do not fit shared memory (``RuntimeError``: the launcher checks
    the device's limit before it launches). Allocates y, the state and, for
    more than one chunk, the workspace of ``plan``; one call counts one
    launch whatever number of CUDA kernels its plan runs."""
    global launches
    _check(x, Bm, Cm, dt, A, D, chunk)
    require_sm90(x, "ssd_scan")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm), ("dt", dt), ("A", A), ("D", D)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if P not in HEAD_DIMS:
        raise ValueError(f"head width P={P} not in {HEAD_DIMS}")
    pl = plan(Bsz, S, H, P, N, chunk, x.dtype)
    lib = LIB.load()
    y = torch.empty_like(x)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ws = (torch.empty((pl.workspace,), dtype=torch.uint8, device=x.device)
          if pl.workspace else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_launch(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(), A.data_ptr(), D.data_ptr(),
        y.data_ptr(), state.data_ptr(), Bsz, S, H, G, P, N, pl.L, DTYPES[x.dtype], pl.warps,
        pl.p_slice, None if ws is None else ws.data_ptr(), stream,
    )
    if err == ERR_SHARED_MEMORY:
        raise RuntimeError(f"ssd_scan: the tiles of P={P} N={N} at chunk {pl.L} "
                           "do not fit the device's shared memory")
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {err}")
    launches += 1
    return y, state


def ssd_scan_bwd_cuda(x, Bm, Cm, dt, A, D, dy, dstate=None, *, chunk: int = 128):
    """Launch the backward kernels (``csrc/ssd_scan_bwd.cu``, ``BWD_KERNELS``
    launches) on the current stream: what ``ssd_scan_bwd_plain`` computes.
    Takes what ``ssd_scan_cuda`` takes, at N <= ``BWD_MAX_N``, with dy
    [B, S, H, P] in x's dtype and dstate [B, H, P, N] float32 or None, all
    contiguous; raises, launching nothing, on anything else (``RuntimeError``
    where the tiles of (P, N, chunk) do not fit shared memory). Allocates the
    gradients and the workspace. Returns (dx, dBm, dCm, ddt, dA, dD)."""
    global bwd_launches
    _check(x, Bm, Cm, dt, A, D, chunk)
    require_sm90(x, "ssd_scan backward")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    named = [("x", x), ("Bm", Bm), ("Cm", Cm), ("dt", dt), ("A", A), ("D", D), ("dy", dy)]
    if dstate is not None:
        named.append(("dstate", dstate))
    for name, t in named:
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous on {x.device}")
    for name, t in (("dt", dt), ("A", A), ("D", D), ("dstate", dstate)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match x {tuple(x.shape)} "
                         f"{x.dtype}")
    if dstate is not None and tuple(dstate.shape) != (Bsz, H, P, N):
        raise ValueError(f"dstate must be [{Bsz}, {H}, {P}, {N}], got {tuple(dstate.shape)}")
    if P not in HEAD_DIMS or N > BWD_MAX_N:
        raise ValueError(f"the backward takes P in {HEAD_DIMS} and N <= {BWD_MAX_N}, "
                         f"got P={P} N={N}")
    L = min(chunk, S)
    lib = LIB_BWD.load()
    ws = torch.empty((lib.ssd_scan_bwd_workspace_bytes(Bsz, S, H, G, P, N, L),),
                     dtype=torch.uint8, device=x.device)
    dx, dB, dC = torch.empty_like(x), torch.empty_like(Bm), torch.empty_like(Cm)
    ddt, dA, dD = torch.empty_like(dt), torch.empty_like(A), torch.empty_like(D)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ssd_scan_bwd_launch(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(), A.data_ptr(), D.data_ptr(),
        dy.data_ptr(), None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dD.data_ptr(),
        ws.data_ptr(), Bsz, S, H, G, P, N, L, DTYPES[x.dtype], stream,
    )
    if err == ERR_SHARED_MEMORY:
        raise RuntimeError(f"ssd_scan backward: the tiles of P={P} N={N} at chunk {L} "
                           "do not fit the device's shared memory")
    if err != 0:
        raise RuntimeError(f"ssd_scan backward launch failed: cudaError {err}")
    bwd_launches += BWD_KERNELS
    return dx, dB, dC, ddt, dA, dD


class SsdScanFn(torch.autograd.Function):
    """The kernel under autograd on CUDA tensors: the forward launches
    ``ssd_scan_cuda`` and saves its inputs (not y); the backward launches
    ``ssd_scan_bwd_cuda`` with y's gradient and the final state's (None
    where the state was not used, as in training)."""

    @staticmethod
    def forward(ctx, x, Bm, Cm, dt, A, D, chunk):  # repro: device-region static[chunk]
        ctx.set_materialize_grads(False)
        y, state = ssd_scan_cuda(x, Bm, Cm, dt, A, D, chunk=chunk)
        ctx.save_for_backward(x, Bm, Cm, dt, A, D)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, Bm, Cm, dt, A, D = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dstate = None if dstate is None else dstate.contiguous()
        grads = ssd_scan_bwd_cuda(x, Bm, Cm, dt, A, D, dy, dstate, chunk=ctx.chunk)
        return (*grads, None)
