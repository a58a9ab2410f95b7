"""Gradient bucketing of the port against the JAX package's.

The bucket plans decide which leaves travel together, so the port must
list the leaves in JAX's order and plan over JAX's stacked shapes:
``make_plan`` must equal ``repro.core.bucketing.make_plan`` field for
field (``leaf_ids``, ``sizes``, ``nbytes``, ``channel``) on the
llama3.2-1b full-width parameters -- the whole stacked tree (bulk and
per_leaf modes) and one layer (partitioned mode) -- built without
allocation (JAX's ``lm.param_shapes``; the port's model on the ``meta``
device).  ``pack``/``unpack`` must equal JAX's bit for bit, with leaves
given as one tensor or as per-layer segments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import bucketing as jb
from repro.models import lm as jlm
from repro_torch.configs import get_config as pget
from repro_torch.core import bucketing as pb
from repro_torch.models import lm as plm

AGGRS = (0, 1 << 20, 4 << 20, 256 << 20)


def _fields(plan):
    return [(b.leaf_ids, b.sizes, b.nbytes, b.channel) for b in plan.buckets]


@pytest.fixture(scope="module")
def full_width():
    """JAX's abstract llama3.2-1b tree and the port's leaves (meta)."""
    jshapes = jlm.param_shapes(jget("llama3.2-1b"))
    model = plm.LM(pget("llama3.2-1b"), device="meta")
    return jshapes, model


def test_port_leaves_follow_jax_order(full_width):
    jshapes, model = full_width
    jpaths = [jax.tree_util.keystr(k) for k, _ in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]]
    leaves = plm.param_leaves(model.named_parameters())
    assert jpaths == ["".join(f"[{p!r}]" for p in name.split("."))
                      for name, _ in leaves]
    for (_, segs), j in zip(leaves, jax.tree.leaves(jshapes)):
        shape = segs[0].shape if len(segs) == 1 else (len(segs),
                                                      *segs[0].shape)
        assert tuple(shape) == tuple(j.shape)


@pytest.mark.parametrize("aggr", AGGRS)
@pytest.mark.parametrize("channels", [1, 3])
def test_plan_equals_jax_stacked_tree(full_width, aggr, channels):
    jshapes, model = full_width
    want = jb.make_plan(jax.tree.leaves(jshapes), aggr, channels)
    leaves = [segs for _, segs in plm.param_leaves(model.named_parameters())]
    got = pb.make_plan(leaves, aggr, channels)
    assert _fields(got) == _fields(want)
    assert got.n_leaves == want.n_leaves
    assert got.total_bytes == want.total_bytes


@pytest.mark.parametrize("aggr", AGGRS)
def test_plan_equals_jax_one_layer(full_width, aggr):
    jshapes, model = full_width
    jlayer = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape[1:],
                                                         s.dtype),
                          jshapes["layers"])
    want = jb.make_plan(jax.tree.leaves(jlayer), aggr)
    leaves = [segs for _, segs in
              plm.param_leaves(model.layers[0].named_parameters())]
    assert _fields(pb.make_plan(leaves, aggr)) == _fields(want)


def test_full_width_multi_leaf_buckets(full_width):
    """The buckets that the pack kernels carry at llama3.2-1b width in
    f32: [ln1, ln2] per layer at 1 MiB (partitioned), and two buckets of
    the stacked tree at 256 MiB (bulk)."""
    _, model = full_width
    names = [n for n, _ in plm.param_leaves(model.named_parameters())]
    layer = [n for n, _ in plm.param_leaves(model.layers[0].named_parameters())]
    part = [b for b in pb.make_plan(
        [s for _, s in plm.param_leaves(model.layers[0].named_parameters())],
        1 << 20).buckets if len(b.leaf_ids) > 1]
    assert [[layer[i] for i in b.leaf_ids] for b in part] == [["ln1", "ln2"]]
    bulk = [b for b in pb.make_plan(
        [s for _, s in plm.param_leaves(model.named_parameters())],
        256 << 20).buckets if len(b.leaf_ids) > 1]
    assert [[names[i] for i in b.leaf_ids] for b in bulk] == [
        ["final_norm", "layers.attn.wk"],
        ["layers.attn.wv", "layers.ln1", "layers.ln2"]]
    assert [b.nbytes for b in bulk] == [8192 + (64 << 20),
                                        (64 << 20) + 2 * 16 * 8192]


def test_auto_needs_the_planner():
    """``"auto"`` is the planner's choice on the gradient scenario, and
    the same plan as the JAX package's."""
    from repro_torch.core import planner
    leaves = [torch.ones(3), torch.ones(1000, 7), torch.ones(5)]
    choice = planner.choose_plan(planner.gradient_desc(
        float(sum(pb.leaf_nbytes(x) for x in leaves))), approaches=("part",))
    got = pb.make_plan(leaves, "auto", "auto")
    assert _fields(got) == _fields(pb.make_plan(
        leaves, int(choice.aggr_bytes), choice.n_vcis))
    want = jb.make_plan([np.ones(3, np.float32), np.ones((1000, 7),
                                                         np.float32),
                         np.ones(5, np.float32)], "auto", "auto")
    assert _fields(got) == _fields(want)


def _mixed(seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(5, 3), (7,), (2, 4, 3), (), (11,)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("aggr", [0, 64, 200, 1 << 20])
def test_pack_unpack_equal_jax(aggr):
    arrs = _mixed()
    jl = [jnp.asarray(a) for a in arrs]
    # leaf 2 travels as per-layer segments of a stacked (2, 4, 3) leaf
    pl = [torch.from_numpy(a) for a in arrs]
    pl[2] = [torch.from_numpy(arrs[2][i]) for i in range(2)]
    plan = pb.make_plan(pl, aggr)
    assert _fields(plan) == _fields(jb.make_plan(jl, aggr))
    for bucket in plan.buckets:
        for dt, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
            flat = pb.pack(pl, bucket, dtype=dt)
            want = jb.pack(jl, bucket, dtype=jdt)
            np.testing.assert_array_equal(flat.float().numpy(),
                                          np.asarray(want, np.float32))
            got = pb.unpack(flat, bucket, pl)
            want_l = jb.unpack(want, bucket, jl)
            for segs, w in zip(got, want_l):
                g = segs[0] if len(segs) == 1 else torch.stack(segs)
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pack_promotes_mixed_dtypes_as_concatenate():
    leaves = [torch.ones(3, dtype=torch.bfloat16), torch.full((2,), 0.1)]
    (bucket,) = pb.make_plan(leaves, 1 << 20).buckets
    flat = pb.pack(leaves, bucket)
    want = jb.pack([jnp.ones(3, jnp.bfloat16),
                    jnp.asarray(np.full(2, 0.1, np.float32))], bucket)
    assert flat.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))


@pytest.mark.parametrize("aggr", [0, 100, 1 << 20])
def test_bucketed_apply_in_place(aggr):
    """fn sees each bucket once, its result lands back in the leaves."""
    arrs = _mixed(1)
    leaves = [torch.from_numpy(a.copy()) for a in arrs]
    leaves[2] = [torch.from_numpy(arrs[2][i].copy()) for i in range(2)]
    seen = []

    def fn(flat, bucket):
        seen.append(bucket.leaf_ids)
        return flat * 2.0

    pb.bucketed_apply(leaves, fn, aggr_bytes=aggr)
    plan = pb.make_plan(leaves, aggr)
    # one call per bucket: the scattered stacked leaf is packed
    assert len(seen) == plan.n_buckets
    for leaf, a in zip(leaves, arrs):
        got = leaf if isinstance(leaf, torch.Tensor) else torch.stack(leaf)
        np.testing.assert_array_equal(got.numpy(), a * 2.0)


def _count_collectives(leaves, aggr, monkeypatch):
    """``bucketed_apply`` on ``leaves`` with a counting ``fn``; packs go
    through the plain versions (they run on ``meta`` tensors too)."""
    from repro_torch.kernels import bucket_pack as bpk
    packs = []

    def plain_pack(segs, dtype=None):
        packs.append(len(segs))
        return bpk.bucket_pack_plain(segs, dtype)
    monkeypatch.setattr(pb.ops, "bucket_pack", plain_pack)
    monkeypatch.setattr(pb.ops, "bucket_unpack", bpk.bucket_unpack_plain)
    calls = []
    pb.bucketed_apply(leaves, lambda flat, b: calls.append(flat.numel())
                      or flat, aggr_bytes=aggr)
    return calls, packs


@pytest.mark.parametrize("mode,aggr,n_ref", [("bulk", 256 << 20, 8),
                                             ("per_leaf", 0, 11)])
def test_full_width_one_collective_per_bucket(full_width, monkeypatch, mode,
                                              aggr, n_ref):
    """llama3.2-1b at full width (``meta``): with the stacked gradient
    buffers of the bulk and per_leaf modes, ``bucketed_apply`` issues
    one collective per bucket of the reference plan on JAX's leaves
    (8 and 11; it was 83 and 146 with one per layer slice), and packs
    only the multi-leaf buckets."""
    from repro_torch.core import earlybird
    jshapes, model = full_width
    want = jb.make_plan(jax.tree.leaves(jshapes), aggr)
    assert want.n_buckets == n_ref
    for p, g in earlybird.stacked_grad_slices(model):
        p.grad = g  # where the backward hooks leave the gradients
    for p in model.parameters():
        if p.grad is None:  # embed, final_norm: one tensor each
            p.grad = torch.empty_like(p)
    try:
        grads = [[p.grad for p in segs] for _, segs in
                 plm.param_leaves(model.named_parameters())]
        calls, packs = _count_collectives(grads, aggr, monkeypatch)
    finally:
        for p in model.parameters():
            p.grad = None
    assert len(calls) == want.n_buckets
    assert calls == [sum(b.sizes) for b in want.buckets]
    assert len(packs) == sum(len(b.leaf_ids) > 1 for b in want.buckets)


def test_scattered_stacked_leaf_is_packed_once(monkeypatch):
    """A stacked leaf whose segments are separate tensors travels as one
    packed collective, not one per segment."""
    segs = [torch.full((3, 2), float(i)) for i in range(4)]
    calls, packs = _count_collectives([segs], 0, monkeypatch)
    assert calls == [24] and packs == [4]
    view = pb._covering_view(list(torch.zeros(4, 3, 2)))
    assert view is not None and view.shape == (24,)
    assert pb._covering_view(list(torch.zeros(4, 3, 2))[::2]) is None


def test_stacked_grads_accumulate_in_place():
    """Backward leaves each stacked leaf's gradients in the slices of
    one buffer, bitwise equal to fresh gradients; a second backward
    accumulates into the slices in place (autograd keeps a ``.grad`` it
    finds), and a parameter that backward never reaches keeps ``.grad``
    None, so the early-bird guard still sees it."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import earlybird
    from repro_torch.data import pipeline
    from repro_torch.launch.steps import batch_to_device, build_state
    cfg = get_smoke_config("llama3.2-1b").replace(param_dtype="float32")
    model = build_state(cfg, 0, "cpu")["params"]
    batch = batch_to_device(pipeline.for_model(cfg, 16, 2).batch(0), "cpu")
    plm.loss_fn(cfg, model, batch).backward()
    fresh = {n: p.grad.clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    handles = earlybird.stack_layer_grads(model)
    stacked = [(n, segs) for n, segs in
               plm.param_leaves(model.named_parameters())
               if n.startswith("layers.")]
    assert len(handles) == sum(len(s) for _, s in stacked)
    assert all(p.grad is None for p in model.parameters())
    plm.loss_fn(cfg, model, batch).backward()
    names = {id(p): n for n, p in model.named_parameters()}
    slices = {}
    for _, segs in stacked:
        view = pb._covering_view([p.grad for p in segs])
        assert view is not None and view.numel() == sum(p.numel()
                                                        for p in segs)
        slices.update((names[id(p)], p.grad) for p in segs)
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, fresh[n]), n
    plm.loss_fn(cfg, model, batch).backward()
    for n, p in model.named_parameters():
        if n in slices:
            assert p.grad is slices[n], n
        assert torch.equal(p.grad, fresh[n] + fresh[n]), n
    for h in handles:
        h.remove()
    for p in model.parameters():
        p.grad = None
    handles = earlybird.stack_layer_grads(model)
    skipped = stacked[0][1][1]  # layer 1 of the first stacked leaf
    sum(p.sum() for p in model.parameters() if p is not skipped).backward()
    assert skipped.grad is None
    assert all(p.grad is not None for p in model.parameters()
               if p is not skipped)
    for h in handles:
        h.remove()
