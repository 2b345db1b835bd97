"""The attention's exchanges where the split plan splits the head width
(``head_dim``) over ``model``, and its attention over the rows they give
(``nn.attention._attend_rows``), on every rank of a model group run in
this one process: no process group, each rank's all-to-all served from
what the ranks sent in the pass before (:class:`_Group`).

``tests/test_torch_tp_head_dim.py`` holds the same path end to end on 4
gloo ranks against the reference's GSPMD programs; here each piece is held
against the unsplit computation, also on a group of one, the identity
exchange of the card's 1 x 1 mesh, where the layers themselves attend
unsplit.
"""

import pytest

torch = pytest.importorskip("torch")

import test_torch_tp as tpt  # noqa: E402

ARCHS = ("qwen2.5-3b", "qwen2-7b", "qwen2-vl-2b")

class _Group:
    """``ways`` ranks of ``model`` in one process: rank ``r``'s i-th
    all-to-all receives what every rank sent in its i-th in the pass
    before (zeros in the first), so a function of the ranks that makes n
    of them is right after n + 1 passes (:meth:`run`)."""

    def __init__(self, ways: int):
        self.ways, self.sent, self.now = ways, {}, {}

    def shard(self, r: int):
        from repro_torch.nn import tensor_parallel as tp
        calls = iter(range(1 << 20))

        def all_to_all(t, send, recv):
            i = next(calls)
            self.now[r, i] = (t.detach().clone(), list(send))
            if (r, i) not in self.sent:
                return t.new_zeros(sum(recv))
            parts = []
            for j in range(self.ways):
                flat, sizes = self.sent[j, i]
                lo = sum(sizes[:r])
                parts.append(flat[lo:lo + sizes[r]])
            out = torch.cat(parts)
            assert out.numel() == sum(recv), (out.numel(), recv)
            return out
        return tp.ModelShard(index=r, ways=self.ways,
                             split=frozenset({"head_dim"}), reduce=None,
                             gather=None, all_to_all=all_to_all)

    def run(self, fn, calls: int) -> list:
        for _ in range(calls + 1):
            self.now = {}
            outs = [fn(self.shard(r)) for r in range(self.ways)]
            self.sent = self.now
        return outs


@pytest.mark.parametrize("b,h,n_kv,ways", [(2, 7, 1, 4), (3, 4, 2, 4),
                                           (1, 2, 1, 4), (2, 28, 4, 16)])
def test_exchanges_trade_columns_for_rows(b, h, n_kv, ways):
    """``tp.to_rows`` and ``tp.to_cols`` on every rank of a model group:
    q's and k's columns of all (batch x head) rows become the rank's rows
    at whole width (ragged; rows fewer than the ranks; a KV row two or
    three ranks share, as qwen2-7b's 7 query heads over one KV head on 4
    ranks), and back; each one's backward the other's exchange, the
    gradients of a shared KV row summed over the ranks that held it.
    Integer values, so every sum is exact."""
    from repro_torch.nn import tensor_parallel as tp
    s, c = 3, 2
    gen = torch.Generator().manual_seed(100 * b + h)

    def ints(n):
        return torch.randint(-8, 8, (n, s, ways * c), generator=gen).float()
    q_all, k_all, gq, gk, gy = (ints(n) for n in (b * h, b * n_kv, b * h,
                                                  b * n_kv, b * h))

    def rank(shard):
        cols = slice(shard.index * c, (shard.index + 1) * c)
        with tp.model_shard(shard):
            rows = tp.row_ranges(b * h)
            kv = tp.kv_ranges(rows, h, n_kv)
            (lo, hi), (klo, khi) = rows[shard.index], kv[shard.index]
            q = q_all[..., cols].clone().requires_grad_()
            k = k_all[..., cols].clone().requires_grad_()
            qr, kr = tp.to_rows([q, k], [rows, kv])
            # each rank's own weights of its rows: a KV row's gradient
            # sums them over the ranks that hold it
            ((qr * gq[lo:hi]).sum()
             + (kr * gk[klo:khi] * (shard.index + 1)).sum()).backward()
            y = q_all[lo:hi].clone().requires_grad_()
            back = tp.to_cols(y, rows, b * h)
            (back * gy[..., cols]).sum().backward()
        return (rows, kv, qr.detach(), kr.detach(), q.grad, k.grad,
                back.detach(), y.grad)

    outs = _Group(ways).run(rank, 4)
    rows, kv = outs[0][:2]
    assert rows[0][0] == 0 and rows[-1][1] == b * h
    held = torch.zeros(b * n_kv)                # sum of (rank + 1) a row
    for r, (lo, hi) in enumerate(kv):
        held[lo:hi] += r + 1
    for r, (_, _, qr, kr, dq, dk, back, dy) in enumerate(outs):
        cols = slice(r * c, (r + 1) * c)
        (lo, hi), (klo, khi) = rows[r], kv[r]
        assert torch.equal(qr, q_all[lo:hi]) and torch.equal(kr,
                                                             k_all[klo:khi])
        assert torch.equal(dq, gq[..., cols])
        assert torch.equal(dk, gk[..., cols] * held[:, None, None])
        assert torch.equal(back, q_all[..., cols])
        assert torch.equal(dy, gy[lo:hi])


@pytest.mark.parametrize("ways", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_attend_rows_is_the_unsplit_attention(arch, ways):
    """``nn.attention._attend_rows``, the attention where the split plan
    splits the head width, on every rank of a model group of ``ways``
    (one: the identity exchange the card's 1 x 1 mesh would make; 4:
    tiny head width 16 split 4 a rank, so RoPE's pairs cross ranks), the
    ranks' columns of its output side by side, against the unsplit path
    (``apply_rope``, then K5's plain version over the KV heads) on the
    same q, k and v: value for value in bf16 and fp32, and q's, k's and
    v's gradients in fp32 at the bar.  B 3 (ragged rows); RoPE, or
    qwen2-vl-2b's M-RoPE at text positions."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.nn import attention
    from repro_torch.nn import tensor_parallel as tp
    from repro_torch.nn.rope import apply_rope
    cfg = tpt._cfg(arch)
    b, s = 3, 12
    h, n_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    c = d // ways
    gen = torch.Generator().manual_seed(7 + ways)
    qkv = [torch.randn(b, s, n, d, generator=gen) for n in (h, n_kv, n_kv)]
    g = torch.randn(b, s, h, d, generator=gen)
    pos = torch.arange(s).expand(b, s)
    rope_kw = dict(theta=cfg.rope_theta, fraction=cfg.rope_fraction,
                   mrope_sections=cfg.mrope_sections or None)
    kw = dict(causal=True, window=None, logit_cap=cfg.attn_softcap)
    for dtype in (torch.bfloat16, torch.float32):
        grad = dtype == torch.float32

        def rank(shard):
            cols = slice(shard.index * c, (shard.index + 1) * c)
            parts = [t.to(dtype)[..., cols].clone().requires_grad_(grad)
                     for t in qkv]
            with tp.model_shard(shard), torch.set_grad_enabled(grad):
                y = attention._attend_rows(*parts, pos, False, rope_kw, kw,
                                           None)
                if grad:
                    (y * g[..., cols]).sum().backward()
            return y.detach(), [p.grad for p in parts]

        outs = _Group(ways).run(rank, 4 if grad else 2)
        full = [t.to(dtype).requires_grad_(grad) for t in qkv]
        with torch.set_grad_enabled(grad):
            qr, kr = apply_rope(full[0], full[1], pos, **rope_kw)
            want = flash_ops.attention(qr, kr, full[2], **kw)
            if grad:
                (want * g).sum().backward()
        got = torch.cat([y for y, _ in outs], dim=-1)
        assert got.dtype == dtype and torch.equal(got, want.detach()), \
            (dtype, (got.float() - want.float()).abs().max())
        if grad:
            for i, t in enumerate(full):
                tpt._hold(torch.cat([gr[i] for _, gr in outs], dim=-1),
                          t.grad, f"grad {'qkv'[i]}")
