"""Tensor parallelism over ``model`` along the head width (``head_dim``)
for the attention (``nn.attention`` under the split plan of
``launch.steps``) on a real mesh of processes, held against the
reference's GSPMD programs with the same shardings.

Tiny qwen2.5-3b, qwen2-7b and qwen2-vl-2b at fp32 activations keep their
binding rules: ``heads`` and ``kv_heads`` whole, ``head_dim`` over
``model`` (their KV heads do not divide the axis at full width), the MLP
over ``mlp``, the vocabulary over ``vocab``.  Each rank projects its
columns of every head; prefill and training trade them in one all-to-all
for a block of the (batch x query-head) rows at whole width, rotate them
there (RoPE pairs dim i with dim i + D/2: on model 4 the tiny head width
of 16 splits 4 a rank, so the pairs cross ranks), attend with K5 (its
plain version here) and trade back; a decode step gathers its token's q
and k whole for the rotation and sums its partial scores over ``model``.
``tests/test_torch_tp.py``'s machinery runs them: one
``torch.multiprocessing`` spawn of 4 gloo processes, the reference in one
subprocess on 4 XLA host devices in the same meshes, the same numpy
weights and batches on both sides; qwen2.5-3b on data 2 x model 2 and
data 1 x model 4, qwen2-7b (7 query heads over one KV head) and
qwen2-vl-2b (patches in front, M-RoPE) on data 1 x model 4.  The train
step takes 4 microbatches of 2 rows, so a rank's rows are parts of
sequences (qwen2-7b's 14 split 4, 4, 3, 3); a second prefill takes 3
rows, whose (batch x head) rows split raggedly and whose KV rows two
ranks share.  Checks, on each case:

* ``tests/test_torch_tp.py``'s checks of the train step (loss, grad norm,
  both moments, the parameters), the prefill, the 4 ticks from a zero
  cache and each rank's cache blocks, at its bars; the 3-row prefill's
  logits at the same bar;
* each rank's parameter bytes are the reference's
  ``params_bytes_per_device``, and the compute reads the local blocks
  themselves (no whole buffer for a split leaf);
* each rank's K/V cache blocks hold its columns of the head width, at
  its model index;
* the collectives: one layer's forward issues the q/k/v exchange and the
  output's (two all-to-alls over ``model``, their bytes counted by hand
  from the rows each rank takes) and two all-reduces, after the
  attention and after the MLP; a prefill only those and the embedding's
  all-reduce and the last logits' gather; a decode step per layer one
  all-gather of the token's q and k, one all-reduce of the fp32 partial
  scores and the two all-reduces;
* K5 runs on the rank's own rows at whole width: the 3-row prefill
  launches it once a layer on exactly the rows the ragged split gives
  the rank, and a layer's training forward on its rows with a gradient.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_tp as tpt  # noqa: E402

from repro_torch.nn import module  # noqa: E402

ARCHS = ("qwen2.5-3b", "qwen2-7b", "qwen2-vl-2b")
CASES = [("2x2", "qwen2.5-3b"), ("1x4", "qwen2.5-3b"), ("1x4", "qwen2-7b"),
         ("1x4", "qwen2-vl-2b")]
#: the train step's microbatches of tpt.BATCH: 2 rows each
MICRO = 4
#: the second prefill's rows
ODD = 3
#: the batch of one layer's forward
LAYER_B = 2


def _rank_rows(n: int, ways: int, m: int) -> range:
    """The rows of ``n`` that model rank ``m`` of ``ways`` attends: the
    first ``n % ways`` ranks one more than the rest."""
    per, extra = divmod(n, ways)
    lo = m * per + min(m, extra)
    return range(lo, lo + per + (m < extra))


def _exchange_bytes(b: int, h: int, n_kv: int, ways: int, seq: int,
                    d: int) -> tuple[int, int]:
    """Counted by hand, the fp32 operand bytes of one layer's two
    exchanges on each rank: q's columns of every row, and k's and v's of
    the KV rows each rank's query rows attend with (one KV row sent to
    every rank whose rows use it); then the rank's own rows at whole
    width, by rank."""
    group = h // n_kv
    kv_rows = sum(len({(r // h, r % h // group)
                       for r in _rank_rows(b * h, ways, m)})
                  for m in range(ways))
    out = (b * h + 2 * kv_rows) * seq * (d // ways) * 4
    back = [len(_rank_rows(b * h, ways, m)) * seq * d * 4
            for m in range(ways)]
    return out, back


def _head_dim_checks(mname: str, mesh, arrays) -> dict:
    """This rank's K5 calls in a 3-row prefill and in one layer's training
    forward and backward, and a decode step's collectives, for the cases
    on this mesh."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.launch.op_inventory import OpInventory
    from repro_torch.nn import tensor_parallel as tp
    from repro_torch.nn import transformer

    res = {}
    for arch in ARCHS:
        if (mname, arch) not in CASES:
            continue
        tag = f"{mname}/{arch}"
        cfg = tpt._cfg(arch)
        _, p_sh = sh.model_param_shardings(cfg, mesh)
        params = sh.shard_tree(module.params_from_numpy(tpt._nest(
            tpt._group(arrays, arch + "/w"), cfg)), p_sh)
        calls = []
        plain = flash_ops.attention

        def spy(q, k, v, **kw):
            calls.append(list(q.shape) + [int(torch.is_grad_enabled()
                                              and q.requires_grad)])
            return plain(q, k, v, **kw)
        flash_ops.attention = spy
        try:
            pre = {k: arrays[f"{arch}/{k}"][:ODD] for k in
                   ("tokens", "patches") if f"{arch}/{k}" in arrays}
            with torch.no_grad():
                steps.make_prefill(cfg)(params, pre)
            res[f"{tag}/k5_prefill"] = np.array(calls, np.int64)
            calls.clear()
            plan = steps.make_prefill(cfg).prepare(params)
            layer = module.map_tree(
                lambda a: a[0].detach().clone().requires_grad_(),
                plan.full_tree()["blocks"]["0"])
            x = torch.randn(LAYER_B, tpt.SEQ, cfg.d_model,
                            generator=torch.Generator().manual_seed(5),
                            requires_grad=True)
            with tp.model_shard(plan.model):
                y, _, _ = transformer.apply_block(cfg, "global", layer, x)
                y.square().sum().backward()
            res[f"{tag}/k5_train"] = np.array(calls, np.int64)
        finally:
            flash_ops.attention = plain
        step = steps.make_serve_step(cfg)
        cache = sh.init_sharded_cache(cfg, tpt.LANES, tpt.MAX_LEN, mesh)
        with torch.no_grad(), OpInventory() as inv:
            step.eager(params, cache, {"tokens": arrays[f"{arch}/tok0"],
                                       "pos": arrays["pos0"]})
        report = inv.report()
        res[f"{tag}/tick_kinds"] = np.array(
            [c.kind for c in report.collectives], dtype=str)
        res[f"{tag}/tick_collectives"] = np.array(
            [[c.group_size, c.operand_bytes] for c in report.collectives],
            np.int64).reshape(-1, 2)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    return tpt.spawn(tmp_path_factory.mktemp("tp_head_dim"), ARCHS,
                     _head_dim_checks, cases=CASES,
                     opts={"micro": MICRO, "odd_lanes": ODD})


def _ways(mname: str) -> tuple[int, int]:
    return tpt.MESHES[mname]


@pytest.mark.parametrize("mname,arch", CASES)
def test_split_plan_holds_only_its_blocks(runs, mname, arch):
    tpt.test_split_plan_holds_only_its_blocks(runs, mname, arch)


@pytest.mark.parametrize("mname,arch", CASES)
def test_sharded_train_step_matches_reference(runs, mname, arch):
    tpt.test_sharded_train_step_matches_reference(runs, mname, arch)


@pytest.mark.parametrize("mname,arch", CASES)
def test_sharded_prefill_and_ticks_match_reference(runs, mname, arch):
    tpt.test_sharded_prefill_and_ticks_match_reference(runs, mname, arch)


@pytest.mark.parametrize("mname,arch", CASES)
def test_ragged_prefill_matches_reference(runs, mname, arch):
    """The 3-row prefill: 3 rows do not divide 2 data ranks, so every rank
    runs all of them (and returns all of them); their (batch x head)
    rows split raggedly over ``model`` (qwen2-7b's 21 as 6, 5, 5, 5) and
    qwen2-vl-2b's ranks share KV rows.  Each rank's logits at the bar."""
    tag = f"{mname}/{arch}"
    want = runs.ref[f"{tag}/prefill_odd"]
    assert want.shape[0] == ODD
    for r in runs.ranks:
        tpt._hold(r[f"{tag}/prefill_odd"], want, "prefill_odd")


@pytest.mark.parametrize("mname,arch", CASES)
def test_cache_blocks_split_the_head_dim(runs, mname, arch):
    """Each rank's K/V cache blocks hold its columns of the head width at
    its model index (16 over 2 or 4 ranks), every KV head and its data
    rows, and the ticks wrote them."""
    tag = f"{mname}/{arch}"
    cfg = tpt._cfg(arch)
    d, ways = cfg.resolved_head_dim, _ways(mname)[1]
    for r in runs.ranks:
        m = int(r[f"{mname}/coord"][1])
        for n in ("k", "v"):
            leaf = f"blocks/0/{n}"
            got = r[f"{tag}/cache/{leaf}"]
            block = r[f"{tag}/cache_block/{leaf}"]
            assert got.shape[-2:] == (cfg.n_kv_heads, d // ways), got.shape
            assert tuple(block[-1]) == (m * d // ways, (m + 1) * d // ways)
            assert np.abs(got).max() > 0, leaf


@pytest.mark.parametrize("mname,arch", CASES)
def test_collectives_are_the_exchanges_and_reductions(runs, mname, arch):
    """One layer's forward over ``model``: the q/k/v exchange, the
    output's, the attention's all-reduce and the MLP's, in that order,
    their bytes counted by hand.  A prefill: the embedding's all-reduce,
    those four a layer, the last logits' all-gather; nothing else, no
    parameter gathered.  A decode step: per layer the all-gather of the
    token's q and k, the all-reduce of its fp32 partial scores (lanes x
    heads x cache length) and the two all-reduces; the embedding's before
    and the logits' gather after."""
    tag = f"{mname}/{arch}"
    cfg = tpt._cfg(arch)
    d_ways, ways = _ways(mname)
    h, n_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    layer = ["all-to-all", "all-to-all", "all-reduce", "all-reduce"]
    act = 2 * tpt.SEQ * cfg.d_model * 4
    out, back = _exchange_bytes(2, h, n_kv, ways, tpt.SEQ, d)
    lanes = tpt.LANES // d_ways
    tick_layer = ["all-gather"] + ["all-reduce"] * 3
    for r in runs.ranks:
        m = int(r[f"{mname}/coord"][1])
        assert list(r[f"{tag}/layer_kinds"]) == layer
        assert r[f"{tag}/layer_collectives"].tolist() == [
            [0, ways, out], [0, ways, back[m]], [1, ways, act],
            [1, ways, act]]
        assert list(r[f"{tag}/prefill_kinds"]) == \
            ["all-reduce"] + layer * cfg.n_layers + ["all-gather"]
        assert all(c[1] == ways for c in r[f"{tag}/prefill_collectives"])
        assert list(r[f"{tag}/tick_kinds"]) == \
            ["all-reduce"] + tick_layer * cfg.n_layers + ["all-gather"]
        tick = r[f"{tag}/tick_collectives"].tolist()
        assert all(c[0] == ways for c in tick)
        for i in range(cfg.n_layers):
            gather, scores = tick[1 + 4 * i], tick[2 + 4 * i]
            assert gather[1] == lanes * (h + n_kv) * d // ways * 4
            assert scores[1] == lanes * h * tpt.MAX_LEN * 4


@pytest.mark.parametrize("mname,arch", CASES)
def test_k5_runs_on_the_ranks_rows_at_whole_width(runs, mname, arch):
    """The 3-row prefill launches K5 (its plain version on the CPU) once a
    layer, at the whole head width, on exactly this rank's (batch x
    query-head) rows of the ragged split, as (rows, S, 1, D).  One
    layer's training forward runs it with a gradient on the rows of a
    batch of 2."""
    tag = f"{mname}/{arch}"
    cfg = tpt._cfg(arch)
    _, ways = _ways(mname)
    h, d = cfg.n_heads, cfg.resolved_head_dim
    s = tpt.SEQ + cfg.n_patches
    for r in runs.ranks:
        m = int(r[f"{mname}/coord"][1])
        for key, b, grad in (("k5_prefill", ODD, 0),
                             ("k5_train", LAYER_B, 1)):
            rows = _rank_rows(b * h, ways, m)
            calls = r[f"{tag}/{key}"].tolist()
            n = cfg.n_layers if key == "k5_prefill" else 1
            shape = [len(rows), s if key == "k5_prefill" else tpt.SEQ, 1, d]
            assert calls == [shape + [grad]] * n, (key, calls)

