"""PyTorch port, `flash_attention_bwd`'s two routes on the CPU
(`kernels/flash_attention.py`, `csrc/flash_attention_bwd_tc.cu`,
`csrc/flash_attention_bwd.cu`, `kernels/_build.py`).

No card, nvcc or triton here, so:
  * the routing runs `_launch_backward` with stand-ins for `_build.load`,
    `launch` and the device check: bf16 at head dim 64, 96 and 128 takes
    the tensor-core library `flash_attention_bwd_tc`, everything else the
    SIMT library, each moving its own counter;
  * the C entry points' argument codes in `_build.ENTRY_POINTS` are held
    against the signatures in the sources;
  * the tensor-core kernel's arithmetic is emulated in float32 PyTorch
    (`_emulate_tc_bwd`, in this file and not the package): it rounds where
    the kernel rounds (the weights P to bf16 as dV's A operand, the score
    gradient dS to the bf16 pair hi + lo as dQ's and dK's, the forward's
    unnormalised weights to bf16 in the output O that Delta = dout . O
    reads) and sums in fp32. Its dq, dk and dv must each stay within
    BWD_FACTOR of the plain backward's (`ref.flash_attention_bwd_ref`,
    autograd through the plain forward) largest error against float64 on
    the same bf16 inputs: the bar the kernel is held to on the card. On an
    H100 a single bf16 rounding of dS failed that bar at gemma2's heads,
    and this emulation with that rounding gave the kernel's dq error there
    to four digits (PERF.md, section 6).

The reference package takes no part: its attention's gradient is autodiff
of `chunked_attention`, against which `test_torch_lm_training.py` holds
`flash_attention_bwd_ref`.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ref as kref

# each of dq, dk and dv within BWD_FACTOR x the plain backward's largest
# error against float64 (chip_smoke's and the card tests' bar)
BWD_FACTOR = 2.0
ROUTES = [(torch.float32, d, "simt") for d in (32, 64, 96, 128)] + [
    (torch.bfloat16, 32, "simt")] + [
    (torch.bfloat16, d, "wgmma") for d in (64, 96, 128)]


class _StandIns:
    """`_launch_backward` with the card taken away: the device check
    returns the CPU, `_build.load` returns the library's name and `launch`
    records its arguments."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(fa_mod, "check_cuda",
                            lambda *a, **k: torch.device("cpu"))
        monkeypatch.setattr(fa_mod._build, "load", lambda name: name)
        monkeypatch.setattr(fa_mod, "launch", self._launch)

    def _launch(self, kernel, fn, device, *args):
        self.calls.append((kernel, fn, args))


def _counters():
    return (fa_mod.BWD_LAUNCHES, fa_mod.BWD_TC_LAUNCHES,
            fa_mod.BWD_SIMT_LAUNCHES)


@pytest.mark.parametrize("dtype,d,route", ROUTES,
                         ids=[f"{str(t)[6:]}-d{d}" for t, d, _ in ROUTES])
def test_backward_route_and_counters(monkeypatch, dtype, d, route):
    """`flash_route` names the route, `_launch_backward` loads that
    route's library with its argument list, sizes the stats scratch by it
    (Sq rounded up to the 64-row q tile on "wgmma") and moves BWD_LAUNCHES
    and the route's own counter by one."""
    assert fa_mod.flash_route(dtype, d) == route
    stand = _StandIns(monkeypatch)
    b, sq, skv, h, kv = 2, 70, 90, 4, 2
    q = torch.zeros(b, sq, h, d, dtype=dtype)
    k = torch.zeros(b, skv, kv, d, dtype=dtype)
    before = _counters()
    dq, dk, dv = fa_mod._launch_backward(
        q, k, k.clone(), q.clone(), causal=True, window=16, softcap=30.0,
        scale=None, q_offset=5)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    [(kernel, lib, args)] = stand.calls
    assert kernel == "flash_attention_bwd"
    assert lib == fa_mod._BWD_LIBRARY[route]
    dims = (b, sq, skv, h, kv, d)
    if route == "simt":
        dims += (int(dtype == torch.bfloat16),)
    assert args[8:] == dims + (1, 16, 5, d ** -0.5, 30.0)
    wgmma = route == "wgmma"
    assert _counters() == (before[0] + 1, before[1] + wgmma,
                           before[2] + (not wgmma))


def test_backward_stats_scratch_rows(monkeypatch):
    """The stats scratch the wrapper allocates: (3, B, H, Sq) for the
    SIMT kernels, Sq rounded up to a whole q tile for the tensor-core
    ones, whose dq launch writes 0s into the padded rows that the dk/dv
    launch reads."""
    sizes = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        if kw.get("dtype") == torch.float32:
            sizes.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return real_empty(*shape, **kw)
    _StandIns(monkeypatch)
    monkeypatch.setattr(fa_mod.torch, "empty", empty)
    for dtype, d in ((torch.bfloat16, 64), (torch.float32, 64)):
        q = torch.zeros(1, 65, 3, d, dtype=dtype)
        k = torch.zeros(1, 65, 3, d, dtype=dtype)
        fa_mod._launch_backward(q, k, k, q, causal=True, window=None,
                                softcap=None, scale=None, q_offset=0)
    assert sizes == [(3, 1, 3, 128), (3, 1, 3, 65)]
    src = (_build.CSRC / "flash_attention_bwd_tc.cu").read_text()
    assert f"constexpr int kRows = {fa_mod.TC_TILE};" in src


@pytest.mark.parametrize("name", ["q", "k", "v", "dout"])
def test_tensor_core_backward_refuses_unaligned_operands(monkeypatch, name):
    """TMA needs 16-byte-aligned bases: the "wgmma" route raises for any
    of its four operands that starts elsewhere, and launches nothing."""
    stand = _StandIns(monkeypatch)
    shapes = {"q": (1, 8, 2, 64), "k": (1, 8, 2, 64), "v": (1, 8, 2, 64),
              "dout": (1, 8, 2, 64)}
    ops = {n: torch.zeros(s, dtype=torch.bfloat16) for n, s in shapes.items()}
    n = int(np.prod(shapes[name]))
    ops[name] = torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(
        shapes[name])
    before = _counters()
    with pytest.raises(ValueError, match=f"{name} starts at an address"):
        fa_mod._launch_backward(ops["q"], ops["k"], ops["v"], ops["dout"],
                                causal=True, window=None, softcap=None,
                                scale=None, q_offset=0)
    assert not stand.calls and _counters() == before


_C_KINDS = {"float": "f", "int": "i"}


def _c_kinds(name):
    """The ctypes codes of a library's extern "C" entry point, read from
    its source: a pointer (any `*`) is "p", an int "i", a float "f"."""
    symbol = _build.ENTRY_POINTS[name][0]
    src = (_build.CSRC / f"{name}.cu").read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert m, f"no extern \"C\" int {symbol}(...) in {name}.cu"
    kinds = ""
    for arg in m.group(1).split(","):
        words = arg.replace("*", " * ").split()
        kinds += "p" if "*" in words else _C_KINDS[words[-2]]
    return kinds


@pytest.mark.parametrize("name", sorted(_build.ENTRY_POINTS))
def test_entry_point_codes_match_the_c_signature(name):
    assert _build.ENTRY_POINTS[name][1] == _c_kinds(name)


# ------------------------------------------------- the rounding emulation

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _bf16_pair(x):
    """x as the kernel feeds it to two products: bf16(x) + bf16(x -
    bf16(x))."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _mask(sq, skv, causal, window, q_offset):
    qpos = torch.arange(sq)[:, None] + q_offset
    kpos = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _group_sum(x, kvh):
    """(B, S, H, D) summed over each KV head's group of query heads."""
    b, s, h, d = x.shape
    return x.reshape(b, s, kvh, h // kvh, d).sum(3)


def _emulate_tc_bwd(q, k, v, dout, *, causal, window, softcap, q_offset):
    """flash_attention_bwd_tc.cu's arithmetic in float32: scores in fp32,
    the forward's unnormalised weights rounded to bf16 in O, Delta = dout
    . O in fp32, P = exp(s - m) / l in fp32, then P rounded to bf16 and dS
    to a bf16 pair before their products, every sum (a GQA group's too) in
    fp32, and the results rounded to bf16 once."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d ** -0.5
    qf, df = q.float(), dout.float()
    kr = k.float().repeat_interleave(g, 2)
    vr = v.float().repeat_interleave(g, 2)
    raw = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    dcap = torch.ones_like(raw)
    if softcap is not None:
        t = torch.tanh(raw / softcap)
        raw, dcap = t * softcap, 1 - t * t
    mask = _mask(sq, skv, causal, window, q_offset)
    s = raw.masked_fill(~mask, -1e9)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    inv_l = 1.0 / e.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", _bf16(e), vr) * inv_l
    delta = (df.permute(0, 2, 1, 3) * o).sum(-1, keepdim=True)
    p = e * inv_l
    dp = torch.einsum("bqhd,bkhd->bhqk", df, vr)
    ds = (p * (dp - delta) * dcap).masked_fill(~mask, 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf16_pair(ds), kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", _bf16_pair(ds), qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), df)
    return (dq.to(torch.bfloat16), _group_sum(dk, kvh).to(torch.bfloat16),
            _group_sum(dv, kvh).to(torch.bfloat16))


def _f64_grads(q, k, v, dout, *, causal, window, softcap, q_offset):
    """(dq, dk, dv) of the exact attention in float64 (the -1e9 mask, no
    rounding anywhere)."""
    leaves = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    qq, kk, vv = leaves
    d, g = q.shape[3], q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", qq,
                     kk.repeat_interleave(g, 2)) * d ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    mask = _mask(q.shape[1], k.shape[1], causal, window, q_offset)
    p = torch.softmax(s.masked_fill(~mask, -1e9), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv.repeat_interleave(g, 2))
    return torch.autograd.grad(out, leaves, dout.double())


# (B, Sq, Skv, H, KV, causal, window, softcap, q_offset)
EMULATION_CASES = {
    "causal_gqa": (2, 160, 160, 6, 2, True, None, None, 0),
    "window_softcap": (1, 192, 192, 4, 2, True, 48, 30.0, 0),
    "noncausal_sq_ne_skv_q_offset": (1, 96, 150, 4, 4, False, None, None,
                                     40),
    # rows from q position 255 + 48 on reach no key: P = 1 / Skv on every
    # key, which reaches dv
    "window_past_the_keys": (1, 64, 256, 4, 2, True, 48, None, 250),
    "gemma2_heads_window_softcap": (2, 200, 200, 32, 16, True, 64, 50.0, 0),
}


@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_tensor_core_rounding_meets_the_float64_bar(case, d):
    b, sq, skv, h, kv, causal, window, cap, off = EMULATION_CASES[case]
    rng = np.random.default_rng(35)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16)
               for s in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)))
    dout = torch.from_numpy(rng.standard_normal((b, sq, h, d)).astype(
        np.float32)).to(torch.bfloat16)
    opts = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    got = _emulate_tc_bwd(q, k, v, dout, **opts)
    plain = kref.flash_attention_bwd_ref(q, k, v, dout, **opts)
    exact = _f64_grads(q, k, v, dout, **opts)
    for name, g, p_, x in zip(("dq", "dk", "dv"), got, plain, exact):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        e_k = (g.double() - x).abs().max().item()
        e_p = (p_.double() - x).abs().max().item()
        assert e_k <= BWD_FACTOR * e_p, (name, e_k, e_p)


def test_emulation_rows_past_the_keys_average_every_key():
    """In the window-past-the-keys case the emulation's rows that no key
    may reach give every key P = 1 / Skv: their dv share is dout / Skv,
    and their dq is 0 (no score gradient through the mask)."""
    b, sq, skv, h, kv, causal, window, cap, off = EMULATION_CASES[
        "window_past_the_keys"]
    rng = np.random.default_rng(36)
    q = torch.from_numpy(rng.standard_normal((b, sq, h, 64)).astype(
        np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((b, skv, kv, 64)).astype(
        np.float32)).to(torch.bfloat16)
    dout = torch.zeros_like(q)
    last = sq - 1                           # q position 313 >= 255 + 48
    dout[:, last] = 1.0
    dq, dk, dv = _emulate_tc_bwd(q, k, k, dout, causal=causal, window=window,
                                 softcap=cap, q_offset=off)
    assert torch.equal(dq[:, last], torch.zeros_like(dq[:, last]))
    want = torch.full_like(dv, 2.0 / skv)   # 2 query heads a KV head
    assert torch.allclose(dv.float(), want.float(), rtol=1e-2, atol=0)
