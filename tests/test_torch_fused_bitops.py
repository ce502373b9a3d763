"""The port's fused-operand bit ops against their compositions and JAX.

`popcount_binop`, `cand_score` and `lowest_set_bit_andnot` replace, at
Handel's call sites, an elementwise chain followed by `popcount_words` or
`lowest_set_bit`.  Here, on CPU tensors, each form's plain version must
equal (1) the composition it replaces, written out in torch as the call
sites wrote it, and (2) the same composition on the JAX side, through the
JAX package's lax twins `_popcount_words_lax` / `_lowest_set_bit_lax`, on
the same numpy inputs.  The row map the CUDA wrappers hand the kernels is
plain Python and is checked against torch's own strides.  A routing test
runs CPU Handel with each attack and spies on the module's fused forms:
every fused site must call its form.  The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wittgenstein_tpu.ops import bitops as jbits
from wittgenstein_tpu_torch.engine import replicate_state
from wittgenstein_tpu_torch.ops import bitops as tbits
from wittgenstein_tpu_torch.ops import kernels
from wittgenstein_tpu_torch.protocols import handel_batched
from wittgenstein_tpu_torch.protocols.handel import HandelParameters

WIDTHS = [1, 2, 3, 64]
FILLS = ["random", "sparse", "zeros", "ones", "top_bit"]
# (a's leading shape, b's leading shape): equal, b broadcast, a broadcast,
# both broadcast against each other
LEADS = [((5, 3), (5, 3)), ((5, 3), (5, 1)), ((1, 3), (5, 3)), ((4, 1, 2), (1, 3, 2))]
SLOTS = [1, 2, 8]


def _words(shape, fill, seed):
    rng = np.random.RandomState(seed)
    if fill == "zeros":
        return np.zeros(shape, np.uint32)
    if fill == "ones":
        return np.full(shape, 0xFFFFFFFF, np.uint32)
    if fill == "top_bit":  # negative as int32
        return np.full(shape, 0x80000000, np.uint32)
    w = rng.randint(0, 1 << 32, size=shape, dtype=np.uint32)
    if fill == "sparse":  # mostly-empty rows with a few set bits
        w = np.where(rng.rand(*shape) < 0.1, w & (1 << rng.randint(0, 32, shape)), 0)
    return w.astype(np.uint32)


def _port(w: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32).copy())


def _lax_pc(x):
    return np.asarray(jbits._popcount_words_lax(jnp.asarray(x)))


def _lax_low(x):
    return np.asarray(jbits._lowest_set_bit_lax(jnp.asarray(x)))


_NP_OPS = {"and": lambda a, b: a & b, "or": lambda a, b: a | b, "andnot": lambda a, b: a & ~b}
_TORCH_OPS = {"and": lambda a, b: a & b, "or": lambda a, b: a | b, "andnot": lambda a, b: a & ~b}


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("lead", LEADS, ids=str)
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("op", ["and", "or", "andnot"])
def test_popcount_binop_matches_composition_and_lax(op, w, lead, fill):
    la, lb = lead
    a = _words(la + (w,), fill, seed=w + len(la))
    b = _words(lb + (w,), "random", seed=w + 7)
    got = tbits.popcount_binop(_port(a), _port(b), op)
    composed = tbits.popcount_words(_TORCH_OPS[op](_port(a), _port(b)))
    want = _lax_pc(_NP_OPS[op](a, b))
    assert got.dtype == torch.int32 and got.shape == torch.broadcast_shapes(la, lb)
    assert torch.equal(got, composed)
    assert np.array_equal(got.numpy(), want)


def _cand_composed(sig, inc, ind, agg):
    """The score sites' composition, as handel_batched wrote it."""
    inc_b, ind_b, agg_b = inc[..., None, :], ind[..., None, :], agg[..., None, :]
    inter = tbits.popcount_words(sig & inc_b) > 0
    cc = torch.where(inter[..., None], sig, sig | inc_b)
    return (
        tbits.popcount_words(cc | ind_b),
        tbits.popcount_words(sig),
        tbits.popcount_words(sig | ind_b),
        (tbits.popcount_words(sig & agg_b) > 0).to(torch.int32),
    )


def _cand_lax(sig, inc, ind, agg):
    """The JAX package's composition (its _recompute_cache_dict)."""
    sig, inc_b, ind_b, agg_b = (jnp.asarray(x) for x in (sig, inc, ind, agg))
    inc_b, ind_b, agg_b = inc_b[..., None, :], ind_b[..., None, :], agg_b[..., None, :]
    pc = jbits._popcount_words_lax
    inter = pc(sig & inc_b) > 0
    cc = jnp.where(inter[..., None], sig, sig | inc_b)
    outs = (pc(cc | ind_b), pc(sig), pc(sig | ind_b), (pc(sig & agg_b) > 0).astype(jnp.int32))
    return tuple(np.asarray(o) for o in outs)


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("k", SLOTS)
@pytest.mark.parametrize("w", WIDTHS)
def test_cand_score_matches_composition_and_lax(w, k, fill):
    lead = (3, 5)
    sig = _words(lead + (k, w), fill, seed=w * 10 + k)
    # node rows: random, with one node emptied so sig ∩ inc = ∅ there
    # takes the |sig ∪ inc ∪ ind| branch
    inc, ind, agg = (_words(lead + (w,), "sparse", seed=w + k + i) for i in range(3))
    inc[0, 0] = 0
    got = tbits.cand_score(*(_port(x) for x in (sig, inc, ind, agg)))
    composed = _cand_composed(*(_port(x) for x in (sig, inc, ind, agg)))
    want = _cand_lax(sig, inc, ind, agg)
    for g, c, j in zip(got, composed, want):
        assert g.dtype == torch.int32 and g.shape == lead + (k,)
        assert torch.equal(g, c)
        assert np.array_equal(g.numpy(), j)
    # without agg: the same s, card and wind, and no aggi
    s, card, wind, aggi = tbits.cand_score(*(_port(x) for x in (sig, inc, ind)))
    assert aggi is None
    assert all(torch.equal(x, y) for x, y in zip((s, card, wind), got))


@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("lead", LEADS, ids=str)
@pytest.mark.parametrize("w", WIDTHS)
def test_lowest_set_bit_andnot_matches_composition_and_lax(w, lead, fill):
    la, lb = lead
    a = _words(la + (w,), fill, seed=3 * w + len(la))
    b = _words(lb + (w,), "sparse", seed=w + 11)
    has, low = tbits.lowest_set_bit_andnot(_port(a), _port(b))
    e = _port(a) & ~_port(b)
    assert has.dtype == torch.bool and low.dtype == torch.int32
    assert torch.equal(has, tbits.popcount_words(e) > 0)
    assert torch.equal(low, tbits.lowest_set_bit(e))
    ej = a & ~b
    assert np.array_equal(has.numpy(), _lax_pc(ej) > 0)
    assert np.array_equal(low.numpy(), _lax_low(ej))
    assert (low[~has] == 32).all()  # the empty-row convention


def _row_offsets(packed, row):
    """What rows.cuh's row_offsets computes on the card, in Python."""
    rank = packed[1]
    shape, sa, sb = packed[2:8], packed[8:14], packed[14:20]
    if rank == 0:  # one leading dim: row r at r * stride
        return row * sa[0], row * sb[0]
    oa = ob = 0
    for d in range(rank - 1, -1, -1):
        row, i = divmod(row, shape[d])
        oa += i * sa[d]
        ob += i * sb[d]
    return oa, ob


@pytest.mark.parametrize(
    "case",
    [
        "contiguous",
        "ver_sig_slice_over_levels",  # _commit's sig_b: sliced, stride 0 over levels
        "node_rows_over_slots",  # a node row broadcast over K
        "scalar_rows",
        "transposed_lead",
    ],
)
def test_row_map_reproduces_strides(case):
    base = torch.arange(2 * 3 * 64, dtype=torch.int32).reshape(2, 3, 64)
    if case == "contiguous":
        a = base.reshape(2, 3, 4, 16)
        b = a + 1
    elif case == "ver_sig_slice_over_levels":
        a = base[..., None, :8].expand(2, 3, 5, 8)
        b = torch.arange(2 * 3 * 5 * 8, dtype=torch.int32).reshape(2, 3, 5, 8)
    elif case == "node_rows_over_slots":
        a = torch.arange(2 * 3 * 8 * 4, dtype=torch.int32).reshape(2, 3, 8, 4)
        b = base[..., :4][:, :, None, :].expand(2, 3, 8, 4)
    elif case == "scalar_rows":
        a, b = base[0, 0], base[1, 2]
    else:
        a = base.reshape(2, 3, 4, 16).transpose(0, 1)
        b = a[:, :1]
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    ea, eb = a.expand(lead + a.shape[-1:]), b.expand(lead + b.shape[-1:])
    packed = kernels.row_map(lead, ea.stride()[:-1], eb.stride()[:-1])
    assert len(packed) == 2 + 3 * kernels.MAX_RANK
    assert packed[0] == int(np.prod(lead)) and packed[1] <= len(lead) and packed[1] != 1
    # every row's offsets land on the first word of that row of each operand
    fa, fb = ea.reshape(-1, ea.shape[-1]), eb.reshape(-1, eb.shape[-1])
    for row in range(packed[0]):
        oa, ob = _row_offsets(packed, row)
        assert int(torch.as_strided(a, (1,), (1,), a.storage_offset() + oa)) == int(fa[row, 0])
        assert int(torch.as_strided(b, (1,), (1,), b.storage_offset() + ob)) == int(fb[row, 0])


@pytest.mark.parametrize(
    "shapes", [((5, 3), (5, 1)), ((1, 3), (5, 3)), ((4, 1, 2), (1, 3, 2)), ((), (3,)),
               ((0,), (1,)), ((2, 3), (3,))],
    ids=str,
)
def test_pair_broadcast_matches_torch(shapes):
    s1, s2 = shapes
    assert kernels._broadcast(s1, s2) == tuple(torch.broadcast_shapes(s1, s2))
    with pytest.raises(ValueError):
        kernels._broadcast(s1 + (2,), s2 + (3,))


def test_fused_dispatch_is_by_device_without_fallback():
    a = _port(_words((5, 4), "random", 1))
    b = _port(_words((5, 4), "random", 2))
    sig = _port(_words((5, 3, 4), "random", 3))
    before = {k.name: k.launches for k in kernels.KERNELS}
    assert torch.equal(tbits.popcount_binop(a, b, "or"), tbits.popcount_binop_plain(a, b, "or"))
    for x, y in zip(tbits.cand_score(sig, a, b, a), tbits.cand_score_plain(sig, a, b, a)):
        assert torch.equal(x, y)
    for x, y in zip(tbits.lowest_set_bit_andnot(a, b), tbits.lowest_set_bit_andnot_plain(a, b)):
        assert torch.equal(x, y)
    assert {k.name: k.launches for k in kernels.KERNELS} == before
    # the kernel wrappers refuse CPU tensors instead of falling back
    with pytest.raises(RuntimeError):
        kernels.popcount_binop(a, b, "and")
    with pytest.raises(RuntimeError):
        kernels.cand_score(sig, a, b, a)
    with pytest.raises(RuntimeError):
        kernels.lowest_set_bit_andnot(a, b)
    with pytest.raises(ValueError):
        tbits.popcount_binop(a, b, "xor")
    with pytest.raises(TypeError):
        tbits.popcount_binop(a, b.to(torch.int64), "and")
    meta = torch.empty((5, 4), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError):
        tbits.lowest_set_bit_andnot(meta, meta)


# fused form -> the (method, count) of the sites that must call it
ROUTES = {
    "suicide_cache": (
        dict(node_count=64, nodes_down=16, threshold=47, byzantine_suicide=True), True,
        {
            "cand_score": {"_recompute_cache_dict": 1, "_commit": 1, "_channel_deliver": 1},
            "popcount_binop": {"_commit": 3},
            "lowest_set_bit_andnot": {"_select": 1},
        },
    ),
    "hidden_nocache": (
        dict(node_count=64, nodes_down=16, threshold=47, hidden_byzantine=True), False,
        {
            "cand_score": {"_channel_deliver": 1, "_select": 1},
            "popcount_binop": {"_commit": 3, "_select": 2},
            "lowest_set_bit_andnot": {"_select": 1},
        },
    ),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_handel_sites_call_the_fused_forms(monkeypatch, name):
    kw, cache, want = ROUTES[name]
    seen = {form: {} for form in want}

    def spy(form):
        real = getattr(handel_batched, form)

        def wrapped(*args, **kwargs):
            caller = sys._getframe(1)
            seen[form].setdefault(caller.f_code.co_name, set()).add(caller.f_lineno)
            return real(*args, **kwargs)

        return wrapped

    for form in want:
        monkeypatch.setattr(handel_batched, form, spy(form))
    net, state = handel_batched.make_handel(HandelParameters(**kw), score_cache=cache, device="cpu")
    net.run_ms_batched(replicate_state(state, 2), 5)
    for form, sites in want.items():
        got = {fn: len(lines) for fn, lines in seen[form].items()}
        assert got == sites, f"{form}: called from {got}, want {sites}"
