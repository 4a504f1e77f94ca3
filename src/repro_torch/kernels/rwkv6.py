"""Wrapper of the RWKV6 WKV recurrence CUDA kernel (`csrc/wkv6.cu`), the
port of `repro.kernels.rwkv6`. Its plain version is `ref.wkv6_ref`;
`ops.wkv6` picks between them by device.

Beyond the Pallas kernel, which starts from a zero state and returns only
`o`, the kernel takes the state in and hands the final state out: prefill
passes the state to decode, and decode carries it from tick to tick in
the cache, as the JAX model's cache does.

`WKV6` is the recurrence with a backward, for training: forward #8 (its
plain version on the CPU), backward `wkv6_backward` in plain PyTorch,
chunk by chunk, as the JAX trainer differentiates its jnp scan (there is
no backward kernel on either side)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check_dtype, check_inputs, launch, ptr

NAME = "wkv6"
ACT_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64)  # the kernel's template instances

# wkv6.cu's kernels, by the code its C entry point takes
KERNELS = {"step": 0, "chunked": 1}
CHUNKED_MIN_T = 16   # from this many steps on, the chunked form
CHUNK = 16           # steps of a chunk, L (the chunked kernel's template)
COL_GROUP = 16       # value columns of the state a chunked block owns


def wkv6_plan(B: int, H: int, T: int, n: int) -> dict:
    """The launch of `wkv6.cu` for (B, H, T, n) inputs, from shapes alone:
    the kernel, its chunk L, the value columns of the state a block owns
    (`col_group`) and the `blocks`, which the C entry point launches as
    they are (it refuses a plan that does not give every (b, h) and column
    one block).

    T < CHUNKED_MIN_T (decode: T = 1) takes `step`: a block of n threads
    per (b, h), thread j holding column j of the state, the T steps one
    after another. Longer T takes `chunked`: a block per (b, h, group of
    COL_GROUP value columns), walking T in windows of 64 steps, each
    window's chunks of L = CHUNK steps computed in parallel and only the
    state's carry from chunk to chunk in sequence (T / L elementwise
    steps, not T dependent sweeps). L = 32 timed slower than 16 at every T
    from 64 to 256 on an H100: a chunk's pair sums grow as L^2."""
    if n not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head size {n} is not one the kernel is "
                         f"built for {HEAD_DIMS}")
    if T < CHUNKED_MIN_T:
        return dict(kernel="step", chunk=0, col_group=n, blocks=B * H)
    return dict(kernel="chunked", chunk=CHUNK, col_group=COL_GROUP,
                blocks=B * H * (n // COL_GROUP))


def wkv6(r, k, v, w, u, s0=None):
    """The recurrence of `ref.wkv6_ref` on CUDA tensors.

    r, k, v, w: (B, H, T, n), one dtype (fp32 or bf16), any strides with
    the last dim contiguous (the model passes (B, T, H, n) tensors
    transposed); n in HEAD_DIMS; the kernel is `wkv6_plan`'s. u: (H, n)
    fp32. s0: the (B, H, n, n) fp32 state to start from, or None for
    zeros. Returns (o, state): o (B, H,
    T, n) in r.dtype, laid out (B, T, H, n) in memory; the final fp32
    state, written over s0 when given (the decode cache is updated in
    place), else a new tensor."""
    check_inputs(NAME, r, k, v, w, u, s0, contiguous=False)
    code = check_dtype(NAME, "r", r, ACT_DTYPES)
    if r.dim() != 4:
        raise ValueError(f"{NAME}: r must be (B, H, T, n), got "
                         f"{tuple(r.shape)}")
    B, H, T, n = r.shape
    plan = wkv6_plan(B, H, T, n)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.dtype != r.dtype or t.shape != r.shape or t.stride(3) != 1:
            raise ValueError(f"{NAME}: {name} must be {r.dtype} "
                             f"{tuple(r.shape)} with a contiguous last dim; "
                             f"got {t.dtype} {tuple(t.shape)} strides "
                             f"{t.stride()}")
    if u.dtype != torch.float32 or tuple(u.shape) != (H, n) \
            or not u.is_contiguous():
        raise ValueError(f"{NAME}: u must be a contiguous fp32 ({H}, {n}); "
                         f"got {u.dtype} {tuple(u.shape)}")
    if s0 is not None and (s0.dtype != torch.float32 or tuple(s0.shape)
                           != (B, H, n, n) or not s0.is_contiguous()):
        raise ValueError(f"{NAME}: s0 must be a contiguous fp32 "
                         f"{(B, H, n, n)}; got {s0.dtype} {tuple(s0.shape)}")
    o = torch.empty((B, T, H, n), dtype=r.dtype, device=r.device).transpose(1, 2)
    state = s0 if s0 is not None else torch.empty(
        (B, H, n, n), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_long * 15)(*[s for t in (r, k, v, w, o)
                                     for s in t.stride()[:3]])
    launch(NAME, "rt_wkv6", r.data_ptr(), k.data_ptr(), v.data_ptr(),
           w.data_ptr(), u.data_ptr(), ptr(s0), state.data_ptr(), o.data_ptr(),
           B, H, T, n, strides, code, KERNELS[plan["kernel"]], plan["chunk"],
           plan["col_group"], plan["blocks"])
    return o, state


def wkv6_backward(r, k, v, w, u, do, s0=None, ds=None, chunk: int = 128):
    """The VJP of `ref.wkv6_ref` in plain PyTorch, `WKV6`'s backward, as
    the JAX trainer differentiates its chunk-rematted scan
    (`repro/models/rwkv.py:122-155`): the state at every chunk boundary
    from a forward sweep, then the chunks in reverse, each chunk's states
    S_{t-1} recomputed from its boundary and stepped back through with
    G = dL/dS_t:

      dr_t = (S_{t-1} + diag(u) k_t v_t^T) do_t
      dk_t = G v_t + (r_t * u)(v_t . do_t)
      dv_t = G^T k_t + (r_t . (u * k_t)) do_t
      dw_t = rowsum(G * S_{t-1});   du += r_t * k_t (v_t . do_t)
      G   <- diag(w_t) G + r_t do_t^T

    Only one chunk's states are alive at a time: (chunk, B, H, n, n) fp32.
    r, k, v, w, do: (B, H, T, n), any strides; u (H, n); s0 the forward's
    starting state (None: zeros); ds the cotangent of the final state
    (None: zero). Returns (dr, dk, dv, dw) in their inputs' dtypes, du in
    u's and ds0 fp32 (B, H, n, n), the cotangent of s0."""
    B, H, T, n = r.shape
    dev = r.device
    # time-major fp32 copies: step t's (B, H, n) rows are contiguous
    rT, kT, vT, wT, doT = (x.float().permute(2, 0, 1, 3).contiguous()
                           for x in (r, k, v, w, do))
    u32 = u.float()
    L = max(1, min(int(chunk), T))
    starts = list(range(0, T, L))
    S = (torch.zeros((B, H, n, n), dtype=torch.float32, device=dev)
         if s0 is None else s0.float().clone())
    bounds = [S]
    for t0 in starts[:-1]:
        S = S.clone()
        for t in range(t0, t0 + L):
            S.mul_(wT[t][..., None]).addcmul_(kT[t][..., None],
                                              vT[t][..., None, :])
        bounds.append(S)
    # the bonus terms, for every step at once
    vdo = (vT * doT).sum(-1, keepdim=True)          # (T, B, H, 1)
    ku = kT * u32
    drT = ku * vdo
    dkT = rT * u32 * vdo
    dvT = (rT * ku).sum(-1, keepdim=True) * doT
    du = (rT * kT * vdo).sum((0, 1))
    G = (torch.zeros((B, H, n, n), dtype=torch.float32, device=dev)
         if ds is None else ds.float().clone())
    dwT = torch.empty_like(wT)
    states = torch.empty((L, B, H, n, n), dtype=torch.float32, device=dev)
    for c in reversed(range(len(starts))):
        t0 = starts[c]
        Lc = min(L, T - t0)
        st = states[:Lc]
        st[0].copy_(bounds[c])
        for i in range(1, Lc):
            torch.mul(st[i - 1], wT[t0 + i - 1][..., None], out=st[i])
            st[i].addcmul_(kT[t0 + i - 1][..., None],
                           vT[t0 + i - 1][..., None, :])
        drT[t0:t0 + Lc] += torch.einsum("lbhij,lbhj->lbhi", st,
                                        doT[t0:t0 + Lc])
        for i in reversed(range(Lc)):
            t = t0 + i
            dkT[t] += torch.einsum("bhij,bhj->bhi", G, vT[t])
            dvT[t] += torch.einsum("bhij,bhi->bhj", G, kT[t])
            dwT[t] = torch.einsum("bhij,bhij->bhi", G, st[i])
            G.mul_(wT[t][..., None]).addcmul_(rT[t][..., None],
                                              doT[t][..., None, :])
    del states, bounds

    def back(xT, like):  # (T, B, H, n) -> (B, H, T, n) in like's dtype
        return xT.permute(1, 2, 0, 3).to(like.dtype)

    return (back(drT, r), back(dkT, k), back(dvT, v), back(dwT, w),
            du.to(u.dtype), G)


class WKV6(torch.autograd.Function):
    """The recurrence with forward `ops.wkv6` (#8 on a CUDA tensor, its
    plain version on the CPU) and the plain chunked backward
    `wkv6_backward`. It saves r, k, v, w, u and s0 and recomputes the
    states in the backward, `chunk` steps at a time (the model passes
    cfg.rwkv_chunk, the chunk of JAX's remat). A given s0 is copied before
    the kernel runs (`ops.wkv6` writes the final state over its s0), so
    the caller's tensor and the saved one stay as they were.

    apply(r, k, v, w, u, s0, chunk, impl) -> (o, final state); shapes and
    dtypes as `wkv6`. Gradients flow to r, k, v, w, u and s0, from the
    cotangents of o and of the final state."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0=None, chunk: int = 128,
                impl: str = "auto"):
        from repro_torch.kernels import ops  # ops imports this module

        s_in = None if s0 is None else s0.detach().clone()
        o, state = ops.wkv6(r, k, v, w, u,
                            s0=None if s_in is None else s_in.clone(),
                            impl=impl)
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, w, u, s_in)
        return o, state

    @staticmethod
    def backward(ctx, do, ds):
        r, k, v, w, u, s0 = ctx.saved_tensors
        dr, dk, dv, dw, du, ds0 = wkv6_backward(
            r, k, v, w, u, do, s0=s0, ds=ds, chunk=ctx.chunk)
        need = ctx.needs_input_grad
        return (dr if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, dw if need[3] else None,
                du if need[4] else None, ds0 if need[5] else None,
                None, None)
