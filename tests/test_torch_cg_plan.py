"""The CG kernel's launch plan (ops/cg3d.py, plan_launch) on the CPU.

The plan is pure Python: the card's occupancy is passed in (here a fixed
count, or a card-free estimate of an H100 SXM's), so no card, no JAX and no
solve is needed. The kernel's arithmetic is held against its plain version
on the card (tests/test_torch_cuda.py); these tests hold what the cut must
give it: every cell in one granule, every granule in one CTA, granules that
do not depend on the plan, no more CTAs than fit at once, and the mode
chosen by the bytes that fit.
"""
import math

import pytest

from smokephysai_tpu_torch.ops import cg3d as cg_ops

SMS = 132  # an H100 SXM
SM_SHARED = 233_472  # shared memory of one of its SMs

# (episodes, d, h, w): the 128^3 episode of the volumetric path, two of
# them (two waves), chip_smoke's [2, 64^3] and odd volume, a volume cut
# along z, y and x, small and degenerate ones, one past the card's shared
# memory
SHAPES = [(1, 128, 128, 128), (2, 128, 128, 128), (2, 64, 64, 64), (1, 37, 53, 29),
          (1, 40, 40, 70), (3, 16, 16, 16), (2, 8, 9, 10), (1, 1, 1, 1), (5, 3, 1, 40),
          (1, 160, 160, 160)]


def estimated(mode, threads, smem_bytes):
    """A card-free estimate of the CTAs one SM holds: by threads (2048),
    registers (64 a thread under the kernels' launch bound) and shared
    memory (1 KB reserved per CTA)."""
    per_sm = min(2048 // threads, 65536 // (64 * threads), 32)
    if smem_bytes:
        per_sm = min(per_sm, SM_SHARED // (smem_bytes + 1024))
    return per_sm


def fixed(n):
    """`ctas_per_sm` of a card whose SMs hold n CTAs of any shape."""
    return lambda *_: n


def _plans(shape, sms=SMS, ctas_per_sm=estimated):
    """The default plan, the other on-chip candidates (every one where the
    batch has at most 1000 granules, else four) and the global mode."""
    others = list(cg_ops.plan_candidates(*shape, sms, ctas_per_sm))
    if shape[0] * cg_ops.Granules(*shape[1:]).count > 1000:
        others = others[::max(1, len(others) // 4)]
    return ([cg_ops.plan_launch(*shape, sms, ctas_per_sm)] + others
            + [cg_ops.plan_launch(*shape, sms, ctas_per_sm, mode="global")])


def cta_granules(plan, episodes, d, h, w, cta):
    """The (episode, granule) pairs CTA `cta` of `plan` owns, as csrc/cg3d.cu
    cuts them: on chip, one brick of an episode in each wave; in the global
    mode, an even share of every episode's granules."""
    gr = cg_ops.Granules(d, h, w)
    if plan.mode == "chip":
        bz, kgy, kgx = plan.brick
        nbz, nby, nbx = cg_ops.bricks(gr, plan.brick)
        e, b = divmod(cta, nbz * nby * nbx)
        bzi, b = divmod(b, nby * nbx)
        byi, bxi = divmod(b, nbx)
        return [(e, (z * gr.ngy + gy) * gr.ngx + gx)
                for e in range(e, episodes, plan.ctas // (nbz * nby * nbx))
                for z in range(bzi * bz, min((bzi + 1) * bz, d))
                for gy in range(byi * kgy, min((byi + 1) * kgy, gr.ngy))
                for gx in range(bxi * kgx, min((bxi + 1) * kgx, gr.ngx))]
    return [(e, g) for e in range(episodes)
            for g in range(gr.count * cta // plan.ctas, gr.count * (cta + 1) // plan.ctas)]


def _ids(shape):
    return "x".join(map(str, shape))


def _cells(box):
    z, y0, y1, x0, x1 = box
    return {(z, y, x) for y in range(y0, y1) for x in range(x0, x1)}


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_granules_cover_every_cell_once(shape):
    """The granules tile each plane on a grid of `rows` x 32 cells: inside
    the volume, each at its own grid place, their cells adding up to the
    volume's (cell by cell where the volume is small)."""
    _, d, h, w = shape
    gr = cg_ops.Granules(d, h, w)
    places, size = set(), 0
    for index in range(gr.count):
        z, y0, y1, x0, x1 = gr.box(index)
        assert 0 <= z < d and 0 < y1 - y0 <= cg_ops.GRANULE_ROWS and y1 <= h
        assert 0 < x1 - x0 <= cg_ops.GRANULE_COLS and x1 <= w
        assert y0 % gr.rows == 0 and x0 % cg_ops.GRANULE_COLS == 0
        places.add((z, y0, x0))
        size += (y1 - y0) * (x1 - x0)
    assert len(places) == gr.count and size == d * h * w
    if d * h * w <= 60_000:
        seen = set()
        for index in range(gr.count):
            cells = _cells(gr.box(index))
            assert not cells & seen
            seen |= cells
        assert len(seen) == d * h * w


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_every_plan_gives_each_granule_to_one_cta(shape):
    """Every plan, in both modes, cuts the batch into whole granules, each
    owned by exactly one CTA; an on-chip CTA owns the same brick of one
    episode in each wave, whose cells are exactly its granules' (the
    brick's edges are granule edges, so a brick changes no sum)."""
    episodes, d, h, w = shape
    gr = cg_ops.Granules(d, h, w)
    for plan in _plans(shape):
        owned = [cta_granules(plan, episodes, d, h, w, c) for c in range(plan.ctas)]
        flat = [t for cta in owned for t in cta]
        assert sorted(flat) == [(e, g) for e in range(episodes) for g in range(gr.count)]
        assert all(owned), plan.describe()
        if plan.mode != "chip":
            continue
        bz, by, bx = cg_ops.brick_dims(gr, plan.brick)
        nbz, nby, nbx = cg_ops.bricks(gr, plan.brick)
        for c, cta in enumerate(owned):
            b = c % (nbz * nby * nbx)
            z0, y0, x0 = b // (nby * nbx) * bz, b // nbx % nby * by, b % nbx * bx
            z1, y1, x1 = min(z0 + bz, d), min(y0 + by, h), min(x0 + bx, w)
            waves = sorted({e for e, _ in cta})
            assert len(waves) in (plan.waves, plan.waves - 1)
            for e in waves:
                mine = [g for e_, g in cta if e_ == e]
                assert len(mine) <= bz * plan.brick[1] * plan.brick[2] == plan.threads // 32
                size = 0
                for g in mine:
                    z, y_0, y_1, x_0, x_1 = gr.box(g)
                    assert z0 <= z < z1 and y0 <= y_0 < y_1 <= y1 and x0 <= x_0 < x_1 <= x1
                    size += (y_1 - y_0) * (x_1 - x_0)
                assert size == (z1 - z0) * (y1 - y0) * (x1 - x0)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plans_fit_the_card(shape):
    """No plan launches more CTAs than the given occupancy holds at once,
    more than 1024 threads a CTA, or more shared memory than a CTA can
    have; the shared memory is what the kernel lays out."""
    episodes, d, h, w = shape
    gr = cg_ops.Granules(d, h, w)
    for sms, occupancy in ((SMS, estimated), (4, estimated), (SMS, fixed(1)), (1, fixed(3))):
        for plan in _plans(shape, sms, occupancy):
            assert 1 <= plan.ctas <= occupancy(plan.mode, plan.threads, plan.smem_bytes) * sms
            assert 32 <= plan.threads <= cg_ops.MAX_THREADS and plan.threads % 32 == 0
            assert plan.smem_bytes <= cg_ops.SMEM_MAX
            if plan.mode == "chip":
                assert plan.smem_bytes == cg_ops.chip_smem_bytes(gr, plan.brick)
                per_wave, rest = divmod(plan.ctas, math.prod(cg_ops.bricks(gr, plan.brick)))
                assert rest == 0 and plan.waves == -(-episodes // per_wave)
            else:
                assert plan.smem_bytes == cg_ops.global_smem_bytes(gr)
                assert plan.ctas <= gr.count


def test_mode_follows_the_bytes():
    """On chip where one episode's bricks fit the card at once: a 128^3
    episode (~16,384 cells and ~225 KB of d, r and p per SM), two of them
    in two waves; not a 160^3 episode (4.1M cells against 132 SMs' 30 MB),
    nor a 128^3 one on a card of 4 SMs or on one that holds no on-chip
    CTA. The forced global mode is one plan for any batch: its CTAs take
    the episodes one at a time."""
    one = cg_ops.plan_launch(1, 128, 128, 128, SMS, estimated)
    two = cg_ops.plan_launch(2, 128, 128, 128, SMS, estimated)
    assert (one.mode, one.waves) == ("chip", 1)
    assert (two.mode, two.waves, two.ctas, two.brick) == ("chip", 2, one.ctas, one.brick)
    assert cg_ops.plan_launch(1, 160, 160, 160, SMS, estimated).mode == "global"
    assert cg_ops.plan_launch(1, 128, 128, 128, 4, estimated).mode == "global"
    no_chip = lambda mode, *_: 0 if mode == "chip" else 1  # noqa: E731
    assert cg_ops.plan_launch(1, 8, 8, 8, SMS, no_chip).mode == "global"
    forced = cg_ops.plan_launch(2, 128, 128, 128, SMS, estimated, mode="global")
    assert forced == cg_ops.plan_launch(1, 128, 128, 128, SMS, estimated, mode="global")
    assert (forced.mode, forced.waves) == ("global", 1)


def test_plan_at_the_main_path_shape():
    """The 128^3 episode: 128 CTAs of 1024 threads, one SM each, a brick
    of 8 planes x 16 rows x 128 columns (one granule a warp): no x faces,
    z and y faces of whole rows."""
    plan = cg_ops.plan_launch(1, 128, 128, 128, SMS, estimated)
    assert (plan.mode, plan.ctas, plan.threads, plan.brick) == ("chip", 128, 1024, (8, 1, 4))
    gr = cg_ops.Granules(128, 128, 128)
    assert cg_ops.bricks(gr, plan.brick) == (16, 8, 1)
    assert plan.smem_bytes == 4 * (10 * 18 * 130 + 2 * 8 * 16 * 128 + 128 + 4 + 1)


def test_granules_do_not_depend_on_the_plan():
    """The granules (and so the order of every sum) are a function of the
    volume alone: the same for any batch, card, occupancy or mode."""
    shape = (37, 53, 29)
    gr = cg_ops.Granules(*shape)
    assert (gr.rows, gr.ngy, gr.ngx, gr.count) == (16, 4, 1, 148)
    for episodes in (1, 3):
        for plan in _plans((episodes, *shape)) + _plans((episodes, *shape), 2, fixed(1)):
            got = {}
            for c in range(plan.ctas):
                for e, g in cta_granules(plan, episodes, *shape, c):
                    got[(e, g)] = gr.box(g)
            assert got == {(e, g): gr.box(g) for e in range(episodes) for g in range(gr.count)}


def test_plan_refuses():
    with pytest.raises(ValueError, match="at least"):
        cg_ops.plan_launch(1, 0, 8, 8, SMS, estimated)
    for mode in ("shared", "chip"):
        with pytest.raises(ValueError, match="mode"):
            cg_ops.plan_launch(1, 8, 8, 8, SMS, estimated, mode=mode)
    with pytest.raises(ValueError, match="does not fit"):
        cg_ops.plan_launch(1, 8, 8, 8, SMS, fixed(0))
    with pytest.raises(ValueError, match="32-bit"):
        cg_ops.plan_launch(1, 1300, 1300, 1300, SMS, estimated)


def test_one_launch_per_solve():
    assert [cg_ops.launches_per_solve(k) for k in (0, 1, 30)] == [1, 1, 1]
