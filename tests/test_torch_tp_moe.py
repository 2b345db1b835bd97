"""Tensor parallelism over ``model`` for the experts (``nn.moe`` under the
split plan of ``launch.steps``) on a real mesh of processes, held against
the reference's GSPMD programs with the same shardings.

Tiny qwen2-moe-a2.7b at fp32 activations keeps the default binding rules:
its attention splits over ``heads`` and ``kv_heads``, its vocabulary over
``vocab``, its 8 experts (6 real, 2 padding) over ``experts`` and its
shared expert's columns over ``mlp``.  ``tests/test_torch_tp.py``'s
machinery runs it: one ``torch.multiprocessing`` spawn of 4 gloo
processes on data 2 x model 2 and then data 1 x model 4, the reference in
one subprocess on 4 XLA host devices in the same meshes, the same numpy
weights and batches on both sides.  Checks, on each mesh:

* that file's checks of the step, the prefill, the 4 ticks and each
  rank's cache blocks (its rows and KV heads), and of the parameter bytes
  and the blocks the compute reads;
* each rank's expert blocks: its contiguous E/ways experts of every
  expert leaf, at its model index (4 of 8 on model 2, 2 on model 4, the
  last rank's the padding experts 6 and 7);
* the collectives: one all-reduce over ``model`` after the attention and
  one after the MoE in a layer's forward; in a prefill only the
  embedding's and those two per layer over ``model``, besides the
  routing's counts exchanged over ``data``, and the last logits'
  all-gather;
* the gradients of the leaves every rank holds whole, the router's and
  the shared expert's gate: equal on every rank of a model group, bit for
  bit, and at the bar against the reference's (its first moment after one
  step over ``1 - b1``), and the router equal on every rank after the
  step;
* a probe MoE layer whose outputs name the kept assignments
  (``tests/test_torch_mesh.py``'s), its 96 tokens in 3 chunks at capacity
  5 with the middle chunk split between the data ranks, routed under both
  splits at once: the kept assignments and the outputs the reference's on
  the whole microbatch, the aux loss on every rank; every rank takes part
  in the one all-reduce over ``model``, and the rank of padding experts
  alone contributes exact zeros.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_mesh as tmesh  # noqa: E402
import test_torch_tp as tpt  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.nn import module, transformer  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
MESHES = tpt.MESHES
#: the probe layer (``tests/test_torch_mesh.py``'s): 96 tokens in 3 chunks
#: of 32, the middle one straddling the data ranks' boundary at token 48
#: on data 2; capacity 5 of its ~10.7 assignments per expert
OVERFLOW = tmesh.OVERFLOW
#: the leaves every rank holds whole whose gradients the split makes partial
WHOLE = ("router/kernel", "shared/gate")


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# each rank's further checks, on each mesh
# ---------------------------------------------------------------------------

def _moe_checks(mname: str, mesh, arrays) -> dict:
    res = {}
    res.update(_expert_blocks(mname, mesh, arrays))
    res.update(_whole_grads(mname, mesh, arrays))
    res.update(_probe(mname, mesh, arrays))
    return res


def _expert_blocks(mname, mesh, arrays) -> dict:
    """This rank's blocks of the expert leaves (every layer) and of the
    shared expert's, with their slices of the whole leaves."""
    from repro_torch.launch import shardings as sh
    cfg = tpt._cfg(ARCH)
    _, p_sh = sh.model_param_shardings(cfg, mesh)
    params = sh.shard_tree(module.params_from_numpy(tpt._nest(
        tpt._group(arrays, ARCH + "/w"), cfg)), p_sh)
    out = {}
    for leaf in ("experts/wi", "experts/wg", "experts/wo", "shared/wi",
                 "shared/wo"):
        t = _at(params, "blocks/0/moe/" + leaf)
        out[f"{mname}/block/{leaf}"] = sh.local(t).numpy()
        out[f"{mname}/slice/{leaf}"] = np.array([
            [b.start, b.stop] for b in mesh.block(sh.sharding_of(t, mesh),
                                                  t.shape)])
    return out


def _whole_grads(mname, mesh, arrays) -> dict:
    """One sharded train step (``tests/test_torch_tp.py``'s) with the
    gradients that reach AdamW read off: this rank's blocks of the
    router's and the shared gate's (the blocks its optimizer state holds),
    their slices, and the router's local parameter after the step."""
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    cfg = tpt._cfg(ARCH, microbatches=tpt.MICRO)
    rules = sh.rules_for(cfg)
    abstract, p_sh = sh.model_param_shardings(cfg, mesh)
    axes = module.axes_tree(transformer.model_specs(cfg))
    o_sh = sh.state_shardings(abstract, axes, mesh, rules)
    micro_sh = {k: sh.sharding_for((tpt.MICRO, tpt.BATCH // tpt.MICRO,
                                    tpt.SEQ), (None, "batch", None), mesh,
                                   rules)
                for k in ("tokens", "targets")}
    w = module.params_from_numpy(tpt._nest(tpt._group(arrays, ARCH + "/w"),
                                           cfg))
    params = sh.shard_tree(module.map_tree(torch.clone, w), p_sh)
    state = sh.shard_tree(adamw.init_state(w), o_sh)
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**tpt.OPT),
                                 microbatch_shardings=micro_sh,
                                 grad_shardings=o_sh["mu"])
    seen = {}
    apply = adamw.apply_updates

    def spy(opt_cfg, p, grads, st, **kw):
        for leaf in WHOLE:
            seen[leaf] = _at(grads, "blocks/0/moe/" + leaf).clone()
        return apply(opt_cfg, p, grads, st, **kw)
    adamw.apply_updates = spy
    try:
        params, state, _ = step(params, state, {
            k: arrays[f"{ARCH}/{k}"] for k in ("tokens", "targets")})
    finally:
        adamw.apply_updates = apply
    out = {}
    for leaf in WHOLE:
        s_ = _at(o_sh["mu"], "blocks/0/moe/" + leaf)
        out[f"{mname}/grad/{leaf}"] = seen[leaf].numpy()
        out[f"{mname}/grad_slice/{leaf}"] = np.array([
            [b.start, b.stop] for b in mesh.block(
                s_, _at(abstract, "blocks/0/moe/" + leaf).shape)])
    out[f"{mname}/router_after"] = sh.local(_at(
        params, "blocks/0/moe/router/kernel")).numpy()
    return out


def _probe(mname, mesh, arrays) -> dict:
    """This rank's data rows of the probe layer through ``moe`` under both
    splits: its block of the microbatch for the routing, its experts and
    shared columns for the compute; the output, the aux loss, the combine
    before the sum over ``model`` and the number of those sums."""
    from repro_torch.nn import moe as moe_lib
    from repro_torch.nn import tensor_parallel as tp
    probe = module.params_from_numpy(tmesh._nest_flat(tpt._group(
        arrays, "probe")))
    x = torch.from_numpy(arrays["probe_x"])
    coord = dict(zip(mesh.axis_names, mesh.coordinate()))
    d_ways, m_ways = mesh.shape["data"], mesh.shape["model"]
    e = probe["router"]["kernel"].shape[1] // m_ways
    f = probe["shared"]["wi"].shape[1] // m_ways
    m = coord["model"]
    local = {"router": probe["router"],
             "experts": {k: v[m * e:(m + 1) * e]
                         for k, v in probe["experts"].items()},
             "shared": {"wi": probe["shared"]["wi"][:, m * f:(m + 1) * f],
                        "wg": probe["shared"]["wg"][:, m * f:(m + 1) * f],
                        "wo": probe["shared"]["wo"][m * f:(m + 1) * f],
                        "gate": probe["shared"]["gate"]}}
    partial = []

    def reduce(t, op):
        partial.append(t.clone())
        return mesh.reduce(t, ("model",))
    shard = tp.ModelShard(index=m, ways=m_ways,
                          split=frozenset({"experts", "mlp"}),
                          reduce=reduce, gather=None, all_to_all=None)
    rows = x.shape[0] // d_ways
    data = moe_lib.BatchShard(index=coord["data"], ways=d_ways,
                              reduce=lambda t: mesh.reduce(t, ("data",)))
    with torch.no_grad(), moe_lib.batch_shard(data), tp.model_shard(shard):
        y, aux = moe_lib.moe(local, x[coord["data"] * rows:
                                      (coord["data"] + 1) * rows],
                             **OVERFLOW)
    return {f"{mname}/probe/y": y.numpy(), f"{mname}/probe/aux": aux.numpy(),
            f"{mname}/probe/sums": np.array(len(partial)),
            f"{mname}/probe/partial": partial[0].numpy()}


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``tests/test_torch_tp.py``'s runs of tiny qwen2-moe-a2.7b, each
    rank's further checks beside them, and the reference's probe layer on
    the whole microbatch on one device."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.nn import moe as ref_moe
    probe, px = tmesh._probe_layer(tpt._cfg(ARCH), 4)
    arrays = {f"probe/{k}": v for k, v in tpt._flat(probe).items()}
    arrays["probe_x"] = px
    out = tpt.spawn(tmp_path_factory.mktemp("tp_moe"), (ARCH,), _moe_checks,
                    arrays)
    y, aux = ref_moe.moe({k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
                          for k, v in probe.items()}, jnp.asarray(px),
                         **OVERFLOW)
    out.probe = {"y": np.asarray(y), "aux": np.asarray(aux), "x": px,
                 "router": probe["router"]["kernel"]}
    return out


@pytest.mark.parametrize("mname", MESHES)
def test_split_plan_holds_only_its_blocks(runs, mname):
    tpt.test_split_plan_holds_only_its_blocks(runs, mname, ARCH)


@pytest.mark.parametrize("mname", MESHES)
def test_sharded_train_step_matches_reference(runs, mname):
    tpt.test_sharded_train_step_matches_reference(runs, mname, ARCH)


@pytest.mark.parametrize("mname", MESHES)
def test_sharded_prefill_and_ticks_match_reference(runs, mname):
    tpt.test_sharded_prefill_and_ticks_match_reference(runs, mname, ARCH)


@pytest.mark.parametrize("mname", MESHES)
def test_each_rank_holds_its_experts(runs, mname):
    """Every expert leaf's block on a rank is its model index's E/ways
    contiguous experts of the whole leaf (all layers, whole within each
    expert); the shared expert's its columns of ``wi`` and rows of
    ``wo``.  On model 4 the last rank holds the padding experts alone."""
    cfg = tpt._cfg(ARCH)
    e, ways = cfg.n_experts_padded, MESHES[mname][1]
    whole = tpt._group(runs.arrays, ARCH + "/w")
    for r in runs.ranks:
        m = int(r[f"{mname}/coord"][1])
        for leaf in ("experts/wi", "experts/wg", "experts/wo"):
            sl = r[f"{mname}/slice/{leaf}"]
            assert sl[1].tolist() == [m * e // ways, (m + 1) * e // ways]
            assert sl[0].tolist() == [0, cfg.n_layers]
            want = whole[f"blocks/0/moe/{leaf}"][:, sl[1][0]:sl[1][1]]
            np.testing.assert_array_equal(r[f"{mname}/block/{leaf}"], want)
        f = cfg.shared_d_ff // ways
        assert r[f"{mname}/slice/shared/wi"][2].tolist() == \
            [m * f, (m + 1) * f]
        assert r[f"{mname}/slice/shared/wo"][1].tolist() == \
            [m * f, (m + 1) * f]
        if ways == 4 and m == 3:
            assert m * e // ways >= cfg.n_experts


@pytest.mark.parametrize("mname", MESHES)
def test_collectives_per_moe_layer(runs, mname):
    """One layer's forward: an all-reduce over ``model`` of (rows, seq, d)
    fp32 after the attention and one after the MoE, nothing else.  A
    prefill: the embedding's and two per layer of this rank's activations
    over ``model``; the routing's counts and summed probabilities over
    ``data`` (2 per layer on data 2, none on data 1); the last logits'
    all-gather."""
    cfg = tpt._cfg(ARCH)
    d_ways, ways = MESHES[mname]
    act = 2 * tpt.SEQ * cfg.d_model * 4
    rows = tpt.LANES // d_ways
    pre_act = rows * tpt.SEQ * cfg.d_model * 4
    for r in runs.ranks:
        layer = r[f"{mname}/{ARCH}/layer_collectives"]
        assert layer.tolist() == [[1, ways, act]] * 2
        pre = r[f"{mname}/{ARCH}/prefill_collectives"].tolist()
        model = [c for c in pre if c[0] and c[2] == pre_act]
        data = [c for c in pre if c[0] and c[2] != pre_act]
        gathers = [c for c in pre if not c[0]]
        assert len(model) == 1 + 2 * cfg.n_layers
        assert all(c[1] == ways for c in model)
        assert len(data) == (2 * cfg.n_layers if d_ways > 1 else 0)
        assert gathers == [[0, ways, rows * cfg.vocab_size // ways * 4]]


@pytest.mark.parametrize("mname", MESHES)
@pytest.mark.parametrize("leaf", WHOLE)
def test_whole_leaves_get_whole_gradients(runs, mname, leaf):
    """The router's and the shared gate's gradients (layer-stacked, the
    block each rank's optimizer state holds): the same bits on every rank
    that holds the block, and at the bar against the reference's gradient
    (its first moment after one step over ``1 - b1``); the router, whole on
    every rank, the same bits on every rank after the step."""
    from repro_torch.optim.adamw import AdamWConfig
    opt = AdamWConfig(**tpt.OPT)
    tag = f"{mname}/{ARCH}"
    ref = runs.ref[f"{tag}/mu/blocks/0/moe/{leaf}"] / (1 - opt.b1)
    # the moment holds the clipped gradient
    clip = min(1.0, opt.clip_norm / float(runs.ref[f"{tag}/m/grad_norm"]))
    by_block: dict = {}
    for r in runs.ranks:
        got = r[f"{mname}/grad/{leaf}"]
        block = tuple(slice(a, b) for a, b in
                      r[f"{mname}/grad_slice/{leaf}"])
        key = str(r[f"{mname}/grad_slice/{leaf}"].tolist())
        if key in by_block:
            np.testing.assert_array_equal(got, by_block[key])
        by_block[key] = got
        assert not tpt._bar(got.astype(np.float64) * clip, ref[block]
                            ).any(), leaf
        assert np.abs(got).max() > 0
    assert len(by_block) == MESHES[mname][0]
    first = runs.ranks[0][f"{mname}/router_after"]
    for r in runs.ranks[1:]:
        np.testing.assert_array_equal(r[f"{mname}/router_after"], first)


@pytest.mark.parametrize("mname", MESHES)
def test_probe_keeps_the_reference_assignments(runs, mname):
    """The probe layer under both splits: the data ranks' rows together
    keep exactly the reference's assignments on the whole microbatch, the
    outputs at rtol 1e-5 / atol 1e-6, the aux loss on every rank.  Some
    assignments drop; on data 2 data rank 1 drops in the middle chunk
    assignments that its own tokens alone would keep.  Every rank makes
    one sum over ``model``; a rank whose experts are padding alone (model
    4's last) contributes exact zeros, the others the kept assignments of
    their own experts only."""
    d_ways, ways = MESHES[mname]
    want = runs.probe["y"]
    e_l = registry.get_tiny(ARCH).n_experts_padded // ways
    by_data = {}
    for r in runs.ranks:
        coord = r[f"{mname}/coord"]
        by_data.setdefault(int(coord[0]), r)
        np.testing.assert_allclose(r[f"{mname}/probe/aux"], runs.probe["aux"],
                                   rtol=tpt.RTOL, atol=tpt.ATOL)
        assert int(r[f"{mname}/probe/sums"]) == 1
        part = r[f"{mname}/probe/partial"].reshape(-1, want.shape[-1])
        m = int(coord[1])
        own = np.zeros(want.shape[-1], bool)
        own[m * e_l:(m + 1) * e_l] = True
        assert not part[:, ~own].any()
        if m * e_l >= OVERFLOW["n_experts"]:
            assert not part.any()
        rows = slice(int(coord[0]) * len(part), (int(coord[0]) + 1)
                     * len(part))
        np.testing.assert_array_equal(
            part[:, own] != 0, want.reshape(-1, want.shape[-1])[rows][:, own]
            != 0)
    got = np.concatenate([by_data[i][f"{mname}/probe/y"]
                          for i in range(d_ways)])
    assert got.shape == want.shape
    kept = tmesh._kept(want)
    np.testing.assert_array_equal(tmesh._kept(got), kept)
    np.testing.assert_allclose(got, want, rtol=tpt.RTOL, atol=tpt.ATOL)
    x = runs.probe["x"].reshape(-1, want.shape[-1])
    logits = x @ runs.probe["router"]
    logits[:, OVERFLOW["n_experts"]:] = -np.inf
    top = np.argsort(-logits, axis=1, kind="stable")[:, :OVERFLOW["top_k"]]
    chosen = np.zeros_like(kept)
    np.put_along_axis(chosen, top, True, axis=1)
    assert (kept <= chosen).all() and kept.sum() < chosen.sum()
    if d_ways == 2:
        alone = np.cumsum(chosen[48:64], axis=0) <= 5   # rank 1's own count
        assert (chosen[48:64] & alone & ~kept[48:64]).any()
