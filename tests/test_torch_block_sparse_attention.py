"""The port's block-sparse attention (paddle_tpu_torch.ops.
block_sparse_attention) and its ``sparse_attention`` functional against
the JAX package's, on the same seeded inputs.

On the CPU the port runs the kernels' plain versions (forward, dQ, dK/dV)
through its ``torch.autograd.Function``; the JAX side runs the three
Pallas kernels under ``interpret=True``, as tests/test_pallas.py does.
Outputs and q/k/v gradients agree within 2e-5 (fp32; the two sides sum in
different orders). The CUDA kernels themselves are held against the plain
versions on the card (tests/test_torch_cuda_kernels.py).
"""
import contextlib
import ctypes
import importlib
import os
import re
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as jax_F
from paddle_tpu.nn.functional import attention as jax_att
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import attention as att
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import block_sparse_attention as bsa

# the module (the package exports a function of the same name)
jax_bsa_mod = importlib.import_module(
    "paddle_tpu.ops.pallas.block_sparse_attention")

pytestmark = pytest.mark.torch_port

ATOL = 2e-5  # fp32: the same arithmetic summed in another order


def _inputs(shape, seed, n=4):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(n)]


def _port(q, k, v, g, fn):
    """fn's output on torch copies of q, k, v and the gradients of
    sum(out * g)."""
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*ts)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def _sides(inputs, mask, causal, got, want):
    """Where each of out, dq, dk, dv (``got`` the port's, ``want`` the
    JAX side's) misses most, each side's distance from the float64 value
    (dense attention under the expanded mask, autograd), and the process
    state a difference between runs of the same inputs could come from
    (thread counts, matmul precisions, XLA flags, denormal flushing, the
    xdist worker): which side moved, when a run misses."""
    q, k, v = (torch.tensor(x, dtype=torch.float64, requires_grad=True)
               for x in inputs[:3])
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    keep = (torch.from_numpy(np.asarray(mask, bool))
            .repeat_interleave(sq // mask.shape[0], 0)
            .repeat_interleave(sk // mask.shape[1], 1))
    if causal:
        keep &= torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1).nan_to_num()
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    (out * torch.from_numpy(inputs[3]).double()).sum().backward()
    lines = []
    for name, a, b, x in zip(("out", "dq", "dk", "dv"), got, want,
                             (out.detach(), q.grad, k.grad, v.grad)):
        b, x = np.asarray(b), x.numpy()
        at = np.unravel_index(int(np.abs(a - b).argmax()), a.shape)
        lines.append(f"{name} worst at {tuple(int(i) for i in at)}: port "
                     f"off float64 by {abs(a[at] - x[at]):.3g}, jax by "
                     f"{abs(b[at] - x[at]):.3g}")
    tiny = np.array([1e-38], np.float32)
    return "; ".join(lines) + (
        f"; torch threads {torch.get_num_threads()}/"
        f"{torch.get_num_interop_threads()}, torch fp32 matmul "
        f"{torch.get_float32_matmul_precision()}, jax matmul "
        f"{jax.config.jax_default_matmul_precision}, XLA_FLAGS "
        f"{os.environ.get('XLA_FLAGS')!r}, numpy flushes denormals "
        f"{bool((tiny * np.float32(0.25))[0] == 0)}, torch flushes "
        f"denormals {bool((torch.from_numpy(tiny) * 0.25)[0] == 0)}, "
        f"worker {os.environ.get('PYTEST_XDIST_WORKER')}")


M_LG = bsa.local_global_mask(2, 2, window=0, global_blocks=1)
BLOCK_CASES = [
    # (b, s, h, d, block_mask, causal)
    (1, 256, 2, 32, M_LG, False),
    (1, 256, 2, 128, bsa.local_global_mask(2, 2, window=1), True),
    (2, 256, 1, 32, np.array([[1, 0], [1, 1]], bool), True),
    (1, 256, 2, 48, np.array([[0, 1], [1, 0]], bool), False),  # D pads
    # blk_q 256, blk_k 128: one q block spans two kernel tiles of kv
    (1, 512, 2, 32, np.array([[1, 1, 0, 0], [1, 0, 1, 1]], bool), True),
    (1, 512, 1, 128, np.array([[1, 0, 0, 1], [0, 1, 1, 0]], bool), False),
    # head dims past 128: in bf16 the card runs the list kernels of
    # attention_wgmma.cuh at 192 and 256 and its D-split kernels past; in
    # fp32 the 3xTF32 forward and dK/dV of attention_tf32.cuh
    (1, 256, 2, 192, M_LG, False),
    # causal at D 192, kv block 2 attended by no q block (dK, dV zero)
    (1, 384, 1, 192, np.array([[1, 0, 0], [1, 1, 0], [0, 1, 0]], bool),
     True),
    (1, 512, 1, 256, np.array([[1, 1, 0, 0], [1, 0, 1, 1]], bool), True),
    (1, 512, 1, 256, np.array([[1, 1, 0, 0], [1, 0, 1, 1]], bool), False),
    # past 256 the card's bf16 forward splits D across two warpgroups
    # (bsa_fwd_dsplit_wgmma_kernel), 256 columns each at D 512
    (1, 256, 1, 512, np.array([[1, 0], [1, 1]], bool), True),
]


@pytest.mark.parametrize("b,s,h,d,mask,causal", BLOCK_CASES)
def test_block_sparse_matches_pallas_interpret(b, s, h, d, mask, causal):
    q, k, v, g = _inputs((b, s, h, d), seed=s + d)

    def jax_loss(qa, ka, va):
        out = jax_bsa_mod.block_sparse_attention(qa, ka, va, mask,
                                                 causal=causal,
                                                 interpret=True)
        return jnp.sum(out * g), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    _build.reset_launches()
    got, got_grads = _port(q, k, v, g, lambda *x: bsa.block_sparse_attention(
        *x, mask, causal=causal))
    assert _build.launches() == {}  # CPU tensors: the plain versions ran
    try:
        _close(got, want)
        for a, ref in zip(got_grads, grads):
            _close(a, ref)
    except AssertionError as miss:
        raise AssertionError(f"{miss}\n" + _sides(
            (q, k, v, g), mask, causal, [got, *got_grads],
            [want, *grads])) from None


def test_fully_masked_rows_are_zero_where_the_reference_is_nan():
    """causal with blk_q 256 > blk_k 128: q block 1 (rows 256..511)
    attends kv block 3 (columns 384..511) alone, so rows 256..383 see no
    unmasked column. The reference returns NaN on exactly those rows; the
    port returns 0 there and equals the reference everywhere else, and its
    gradients are finite."""
    mask = np.array([[1, 1, 0, 0], [0, 0, 0, 1]], bool)
    q, k, v, g = _inputs((1, 512, 2, 32), seed=5)
    want = np.asarray(jax_bsa_mod.block_sparse_attention(
        q, k, v, mask, causal=True, interpret=True))
    got, grads = _port(q, k, v, g, lambda *x: bsa.block_sparse_attention(
        *x, mask, causal=True))
    nan_rows = np.isnan(want).any(axis=(0, 2, 3))
    np.testing.assert_array_equal(np.flatnonzero(nan_rows),
                                  np.arange(256, 384))
    assert np.isnan(want[:, nan_rows]).all()
    assert (got[:, nan_rows] == 0).all()
    _close(got[:, ~nan_rows], want[:, ~nan_rows])
    assert all(np.isfinite(x).all() for x in grads)
    # the rows' gradients are zero: they depend on nothing
    assert (grads[0][:, nan_rows] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_launch_orders_are_heaviest_first(causal):
    """BlockMask's launch orders (the wgmma kernels' grid walks them) are
    permutations of the q and kv blocks with the longest lists first, ties
    in index order: on a BigBird-like pattern the global kv blocks, which
    every q block attends, launch first, and a kv block nothing attends
    last."""
    rs = np.random.RandomState(3)
    mask = bsa.local_global_mask(16, 16, window=1, global_blocks=2)
    for i in range(16):
        mask[i, rs.choice(16, 2, replace=False)] = True
    mask[:, 9] = False  # kv block 9: nothing attends
    spec = bsa.block_mask_spec(mask, 2048, 2048, causal)
    for order, counts in ((spec.order_q, spec.counts),
                          (spec.order_kv, spec.rcounts)):
        assert order.dtype == np.int32
        np.testing.assert_array_equal(np.sort(order), np.arange(16))
        heavy = counts[order]
        assert (np.diff(heavy) <= 0).all()
        ties = heavy[1:] == heavy[:-1]
        assert (order[1:][ties] > order[:-1][ties]).all()
    assert spec.rcounts[9] == 0 and spec.order_kv[-1] == 9
    if not causal:
        np.testing.assert_array_equal(spec.order_kv[:2], [0, 1])
        assert spec.rcounts[0] == spec.rcounts[1] == 16
    # the device copies the kernels read, in the lists' order
    lists = spec.lists("cpu")
    assert [t.dtype for t in lists] == [torch.int32] * 6
    np.testing.assert_array_equal(lists[2].numpy(), spec.order_q)
    np.testing.assert_array_equal(lists[5].numpy(), spec.order_kv)


def test_lists_equal_the_reference_arrays(monkeypatch):
    """local_global_mask, and the q-major and kv-major lists the three
    reference kernels receive (read from their scalar-prefetch operands),
    equal the port's."""
    for args in [(4, 4, 1, 0, False), (4, 8, 2, 1, False), (8, 8, 1, 2, True),
                 (6, 3, 0, 1, True), (3, 5, 2, 0, True)]:
        np.testing.assert_array_equal(bsa.local_global_mask(*args),
                                      jax_bsa_mod.local_global_mask(*args))
    mask = np.array([[1, 0, 1, 0], [0, 0, 1, 1], [1, 0, 0, 0],
                     [1, 0, 1, 1]], bool)  # kv block 1: nothing attends
    seen = []
    real = jax_bsa_mod.pl.pallas_call

    def spy(*a, **kw):
        call = real(*a, **kw)

        def run(idx, counts, *rest):
            seen.append((np.asarray(idx), np.asarray(counts)))
            return call(idx, counts, *rest)
        return run

    monkeypatch.setattr(jax_bsa_mod.pl, "pallas_call", spy)
    q = np.zeros((1, 512, 1, 64), np.float32)
    jax.grad(lambda x: jnp.sum(jax_bsa_mod.block_sparse_attention(
        x, x, x, mask, interpret=True)))(q)
    spec = bsa.block_mask_spec(mask, 512, 512, causal=False)
    (f_idx, f_cnt), (dq_idx, dq_cnt), (kv_idx, kv_cnt) = seen
    for idx, cnt in ((f_idx, f_cnt), (dq_idx, dq_cnt)):
        np.testing.assert_array_equal(spec.cols, idx)
        np.testing.assert_array_equal(spec.counts, cnt)
    np.testing.assert_array_equal(spec.rows, kv_idx)
    np.testing.assert_array_equal(spec.rcounts, kv_cnt)
    assert spec.rcounts[1] == 0


def test_causal_drop_and_checks_are_the_reference():
    mask = np.ones((2, 4), bool)
    spec = bsa.block_mask_spec(mask, 512, 512, causal=True)
    np.testing.assert_array_equal(spec.mask, [[1, 1, 0, 0], [1, 1, 1, 1]])
    x = torch.zeros(1, 256, 1, 32)
    with pytest.raises(ValueError, match="every query block"):
        bsa.block_sparse_attention(x, x, x, np.array([[1, 0], [0, 0]], bool))
    with pytest.raises(ValueError, match="does not tile"):
        bsa.block_sparse_attention(x, x, x, np.ones((3, 3), bool))
    with pytest.raises(ValueError, match="128-multiples"):
        bsa.block_sparse_attention(x, x, x, np.ones((4, 4), bool))
    with pytest.raises(ValueError, match="every query block"):
        jax_bsa_mod.block_sparse_attention(
            x.numpy(), x.numpy(), x.numpy(), np.array([[1, 0], [0, 0]], bool),
            interpret=True)


def test_kernel_route_raises_without_a_card():
    """Forcing the kernel on a CPU tensor raises; nothing falls back."""
    spec = bsa.block_mask_spec(np.ones((2, 2), bool), 256, 256, False)
    x = torch.zeros(2, 256, 64)
    with pytest.raises(ValueError, match="CUDA"):
        bsa.bsa_fwd(x, x, x, spec, False, 0.125, impl="cuda")


C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float,
           "unsigned": ctypes.c_uint32}


def c_params(source: str, entry: str):
    """(type, name) of each parameter of the C entry ``entry`` in
    ``csrc/<source>.cu``."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    decl = re.search(r"\bint " + entry + r"\((.*?)\)\s*\{", text, re.S)
    params = []
    for arg in decl.group(1).split(","):
        typ, name = " ".join(arg.split()).rsplit(" ", 1)
        params.append((typ, name))
    return params


@pytest.mark.parametrize("entry", ["bsa_fwd_launch", "bsa_dq_launch",
                                   "bsa_dkv_launch"])
def test_signatures_match_the_c_entries(entry):
    """The ctypes signature the wrapper sets is the C entry's, slot by
    slot: a pointer where the entry takes one, an int or a float where it
    takes that."""
    lib = types.SimpleNamespace(**{
        name: types.SimpleNamespace(argtypes=None, restype=None)
        for name in ("bsa_fwd_launch", "bsa_dq_launch", "bsa_dkv_launch",
                     "bsa_error_string")})
    bsa.set_signatures(lib)
    params = c_params("block_sparse_attention", entry)
    assert getattr(lib, entry).argtypes == [C_TYPES[t] for t, _ in params]
    assert getattr(lib, entry).restype is ctypes.c_int


def test_forward_launcher_passes_the_launch_order(monkeypatch):
    """bsa_fwd hands the C entry the q-major lists and their launch order
    (order_q, which the wgmma forward's grid walks) in the slots the entry
    names them, and the geometry after them: a stub library records the
    call."""
    calls = []
    stub = types.SimpleNamespace(
        bsa_fwd_launch=lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(bsa, "_kernel_lib", lambda: stub)
    monkeypatch.setattr(bsa, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=77))
    mask = bsa.local_global_mask(4, 2, window=0, global_blocks=1)
    mask[3, :] = True  # q block 3 has the longest list
    spec = bsa.block_mask_spec(mask, 512, 512, False)
    q, k, v = (torch.zeros(3, 512, 128, dtype=torch.bfloat16)
               for _ in range(3))
    bsa.bsa_fwd(q, k, v, spec, False, 0.25, impl="cuda")
    _build.reset_launches()
    (args,) = calls
    names = [name for _, name in c_params("block_sparse_attention",
                                          "bsa_fwd_launch")]
    got = dict(zip(names, args, strict=True))
    cols, counts, order_q = spec.lists(torch.device("cpu"))[:3]
    assert order_q.tolist()[0] == 3
    assert [got[n] for n in ("q", "k", "v", "cols", "counts", "order_q")] \
        == [t.data_ptr() for t in (q, k, v, cols, counts, order_q)]
    assert [got[n] for n in ("a_max", "bh", "sq", "sk", "head_dim", "blk_q",
                             "blk_k", "causal", "scale", "dtype",
                             "stream")] == [
        cols.shape[1], 3, 512, 512, 128, 128, 256, 0, 0.25, 1, 77]


# ----------------------------------------------- the functional, end to end

def _csr_from_blocks(blocks, blk, b, h):
    """A CSR pattern [B, H, T + 1] / [B, H, nnz] that is exactly the block
    mask's elements, the same for every (batch, head)."""
    el = np.kron(blocks, np.ones((blk, blk), bool))
    t = el.shape[0]
    off = np.zeros(t + 1, np.int64)
    cols = []
    for i in range(t):
        cs = np.nonzero(el[i])[0]
        cols.extend(cs)
        off[i + 1] = len(cols)
    return (np.broadcast_to(off, (b, h, t + 1)).copy(),
            np.broadcast_to(np.asarray(cols, np.int64),
                            (b, h, len(cols))).copy())


def _jax_sparse(q, k, v, g, off, cols, kpm=None):
    """The reference functional's output and q/k/v gradients of
    sum(out * g), through its own tape."""
    ts = [paddle.to_tensor(x, stop_gradient=False) for x in (q, k, v)]
    extra = {} if kpm is None else dict(
        key_padding_mask=paddle.to_tensor(kpm))
    out = jax_F.sparse_attention(*ts, paddle.to_tensor(off),
                                 paddle.to_tensor(cols), **extra)
    (out * paddle.to_tensor(g)).sum().backward()
    return out.numpy(), [t.grad.numpy() for t in ts]


@pytest.fixture
def jax_block_route(monkeypatch):
    """The reference's block route opened on the CPU (its Pallas kernels
    then run in interpret mode), as tests/test_pallas.py does."""
    from paddle_tpu.core.flags import get_flags, set_flags

    prior = get_flags(["FLAGS_use_pallas_attention"])
    monkeypatch.setattr(jax_att, "_pallas_backend_ok", lambda: True)
    set_flags({"FLAGS_use_pallas_attention": True})
    jax_att._ROUTE_CACHE.clear()
    jax_att._ROUTE_ID_CACHE.clear()
    yield
    set_flags(prior)


def _port_sparse(q, k, v, g, off, cols, kpm=None):
    extra = {} if kpm is None else dict(
        key_padding_mask=torch.from_numpy(kpm))
    return _port(q, k, v, g, lambda *x: F.sparse_attention(
        *x, torch.from_numpy(off), torch.from_numpy(cols), **extra))


SLICE_BLOCKS = [
    bsa.local_global_mask(2, 2, window=0, global_blocks=1),
    bsa.local_global_mask(3, 3, window=1),
]


@pytest.mark.parametrize("route", ["jax_dense", "jax_block"])
@pytest.mark.parametrize("blocks", SLICE_BLOCKS)
def test_sparse_attention_matches_the_reference(request, route, blocks):
    """A block-aligned uniform pattern takes the port's block route; the
    reference computes it on its CPU dense route and, opened, on its
    block route: the port equals both."""
    if route == "jax_block":
        request.getfixturevalue("jax_block_route")
    b, h, d = 2, 2, 32
    t = 128 * blocks.shape[0]
    off, cols = _csr_from_blocks(blocks, 128, b, h)
    q, k, v, g = _inputs((b, h, t, d), seed=t)
    assert att.would_use_block_sparse(torch.zeros(b, h, t, d),
                                      torch.from_numpy(off),
                                      torch.from_numpy(cols))
    want, want_grads = _jax_sparse(q, k, v, g, off, cols)
    got, got_grads = _port_sparse(q, k, v, g, off, cols)
    _close(got, want)
    for a, ref in zip(got_grads, want_grads):
        _close(a, ref)


def _ragged_csr(b, h, t, seed):
    """A per-(batch, head) ragged pattern: row i attends a random subset
    of columns (some rows none)."""
    rs = np.random.RandomState(seed)
    offs, colss = [], []
    for _ in range(b * h):
        off, cols = [0], []
        for i in range(t):
            cs = np.flatnonzero(rs.rand(t) < 0.1)
            cols.extend(cs)
            off.append(len(cols))
        offs.append(off)
        colss.append(cols)
    nnz = max(len(c) for c in colss)
    cols = np.zeros((b * h, nnz), np.int64)
    for i, c in enumerate(colss):
        cols[i, :len(c)] = c
    return (np.asarray(offs, np.int64).reshape(b, h, t + 1),
            cols.reshape(b, h, nnz))


@pytest.mark.parametrize("case", ["ragged", "key_padding_mask"])
def test_dense_route_matches_the_reference(jax_block_route, case):
    """A ragged pattern, or any pattern with a key-padding mask, takes the
    dense masked composition in both packages (the reference's route
    opened, so only its predicate declines)."""
    b, h, t, d = 1, 2, 256, 16
    q, k, v, g = _inputs((b, h, t, d), seed=11)
    kpm = None
    if case == "ragged":
        off, cols = _ragged_csr(b, h, t, seed=3)
    else:
        off, cols = _csr_from_blocks(np.ones((2, 2), bool), 128, b, h)
        kpm = (np.arange(t) < 200).astype(np.float32)[None].repeat(b, 0)
    ts = [torch.from_numpy(x) for x in (off, cols)]
    extra = {} if kpm is None else dict(key_padding_mask=kpm)
    assert not att.would_use_block_sparse(torch.zeros(b, h, t, d), *ts,
                                          **extra)
    if case == "ragged":
        pt = [paddle.to_tensor(x) for x in (q, off, cols)]
        assert jax_att._try_block_sparse_route(pt[0], pt[0], pt[0], pt[1],
                                               pt[2]) is None
    want, want_grads = _jax_sparse(q, k, v, g, off, cols, kpm)
    got, got_grads = _port_sparse(q, k, v, g, off, cols, kpm)
    _close(got, want)
    for a, ref in zip(got_grads, want_grads):
        _close(a, ref)


def test_route_cache_sees_a_pattern_written_in_place(monkeypatch):
    """The route cache keys on the CSR tensors' identity and version: a
    repeated call copies and analyses nothing, and a pattern written in
    place is analysed again and routed by its new content."""
    b, h, t, d = 1, 1, 256, 16
    off, cols = _csr_from_blocks(np.ones((2, 2), bool), 128, b, h)
    off_t, cols_t = torch.from_numpy(off), torch.from_numpy(cols)
    q = torch.zeros(b, h, t, d)
    calls = []
    real = att._analyse
    monkeypatch.setattr(att, "_analyse",
                        lambda *a: calls.append(1) or real(*a))
    att._ROUTE_CACHE.clear()
    att._ROUTE_ID_CACHE.clear()
    assert att.would_use_block_sparse(q, off_t, cols_t)
    assert att.would_use_block_sparse(q, off_t, cols_t)
    assert len(calls) == 1
    # move one column from row 4 to row 5: no longer block-aligned
    off_t[..., 5] -= 1
    assert not att.would_use_block_sparse(q, off_t, cols_t)
    assert len(calls) == 2
    qs, ks, vs, g = _inputs((b, h, t, d), seed=2)
    want, _ = _jax_sparse(qs, ks, vs, g, off_t.numpy(), cols)
    got, _ = _port_sparse(qs, ks, vs, g, off_t.numpy(), cols)
    _close(got, want)


@pytest.mark.parametrize("route", ["block", "dense"])
def test_o2_casts_sparse_attention_as_the_reference(route):
    """Under O2 the op ``sparse_attention``, on neither AMP list, runs with
    its fp32 inputs cast to bf16 in both packages, on either route."""
    from paddle_tpu import amp as jax_amp
    from paddle_tpu_torch import amp

    b, h, t, d = 1, 1, 256, 16
    if route == "block":
        off, cols = _csr_from_blocks(np.ones((2, 2), bool), 128, b, h)
    else:
        off, cols = _ragged_csr(b, h, t, seed=1)
    q, k, v, _ = _inputs((b, h, t, d), seed=4)
    with jax_amp.auto_cast(level="O2"):
        want = jax_F.sparse_attention(*(paddle.to_tensor(x)
                                        for x in (q, k, v, off, cols)))
    with amp.auto_cast("O2"):
        got = F.sparse_attention(*(torch.from_numpy(x)
                                   for x in (q, k, v, off, cols)))
    assert np.dtype(want.numpy().dtype).name == "bfloat16"
    assert got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
