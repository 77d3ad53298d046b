"""Route L of the greedy NMS kernel (K3) replayed on the CPU, and the pure
Python geometry of both routes.

``greedy_nms_sorted_plain`` below takes route L's steps as the kernels in
``e_osvos_torch/csrc/nms.cu`` take them (rank by counting, the IoU bitmask
words of the score order, the chunked scan); its picks must equal, index for index, the JAX oracle ``e_osvos_tpu.ops.nms.nms``
and the Pallas kernel in interpret mode, and so must the twin
``greedy_nms_plain``. The cases are every case of
``test_torch_port_detection_ops.py`` plus the edges of the score order and
the IoU: -0.0/+0.0 ties, +inf scores, NaN coordinates, zero-area boxes,
max_out past the alive boxes, several chunks of 64, and a batch."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from e_osvos_tpu.ops import nms as jnms
from e_osvos_tpu.ops.pallas_nms import nms_pallas
from e_osvos_torch.ops import cuda_nms
from test_torch_port_detection_ops import NMS_CASES, _nms_case, random_boxes


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this module runs: the tier-1 command
    shares the host's cores among six workers, where a worker's default of
    one thread a core oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---- route L, step by step on CPU tensors

_TILE = cuda_nms.TILE
_BIT = torch.tensor([1 << k if k < 63 else -(1 << 63) for k in range(_TILE)],
                    dtype=torch.int64)
_WORD = (1 << 64) - 1


def tile_pair(p, tiles):
    """Mask block ``p`` → (row tile, column tile ≥ row tile): the upper
    triangle of ``tiles x tiles`` row by row, as ``nms_mask_kernel`` maps
    its ``blockIdx.x`` (the same arithmetic)."""
    a = 2.0 * tiles + 1.0
    r = int((a - math.sqrt(a * a - 8.0 * p)) * 0.5)
    r = max(0, min(tiles - 1, r))

    def start(q):
        return q * tiles - q * (q - 1) // 2

    while r > 0 and start(r) > p:
        r -= 1
    while r + 1 < tiles and start(r + 1) <= p:
        r += 1
    return r, r + p - start(r)


def score_rank_plain(scores, alive):
    """Rank (a): the number of alive boxes that beat each box, ``s_j > s_i``
    or ``s_j == s_i`` and ``j < i``; a float comparison, so -0.0 ties with
    +0.0. Meaningful where ``alive``."""
    n = scores.shape[-1]
    s = torch.where(alive, scores, torch.nan)
    sj, si = s[..., None, :], s[..., :, None]
    lane = torch.arange(n)
    before = lane[None, :] < lane[:, None]  # [i, j]: j < i
    return ((sj > si) | ((sj == si) & before)).sum(-1)


def suppression_words(sorted_boxes, iou_threshold, n):
    """Mask (b) over boxes in score order ``[m, 4]``: ``[m, ceil(n / 64)]``
    int64 words, bit k of word c of row i set when box ``64*c + k`` comes
    after box i and ``!(iou(i, j) <= thr)``, the IoU taking box i as the
    winner."""
    m = sorted_boxes.shape[0]
    words, _ = cuda_nms.mask_grid(n)
    kill = ~(cuda_nms.iou_one_vs_all(sorted_boxes, sorted_boxes)
             <= iou_threshold)
    kill &= torch.ones(m, m, dtype=torch.bool).triu(1)
    bits = torch.zeros(m, words * _TILE, dtype=torch.bool)
    bits[:, :m] = kill
    return (bits.view(m, words, _TILE).long() * _BIT).sum(-1)


def scan_words(words, max_out):
    """Scan (c): the kept positions of the score order, walking it in
    chunks of 64 with a removed bit-vector, as ``nms_scan_kernel`` does: in
    a chunk, the live boxes in no conflict with another live box of the
    chunk are kept at once, the others walked in order."""
    m = words.shape[0]
    rows = [[w & _WORD for w in row] for row in words.tolist()]
    removed = [0] * words.shape[1]
    kept = []
    for c in range(-(-m // _TILE)):
        base = c * _TILE
        n = min(_TILE, m - base)
        diag = [rows[base + k][c] for k in range(n)]
        live = ((1 << n) - 1) & ~removed[c]
        involved = 0
        for k in range(n):
            hit = diag[k] & live if live >> k & 1 else 0
            involved |= hit | (1 << k if hit else 0)
        keep, todo = live & ~involved, live & involved
        while todo:
            k = (todo & -todo).bit_length() - 1
            keep |= 1 << k
            todo &= ~diag[k]
            todo &= todo - 1
        chunk = [base + k for k in range(n) if keep >> k & 1]
        kept += chunk[:max_out - len(kept)]
        if len(kept) >= max_out:
            break
        for p in chunk:
            for w in range(c + 1, len(removed)):
                removed[w] |= rows[p][w]
    return kept


def greedy_nms_sorted_plain(boxes, scores, valid, iou_threshold, max_out):
    """Route L's algorithm, image by image: rank by counting, the boxes in
    score order, the suppression words, the chunked scan. The same picks
    as ``cuda_nms.greedy_nms_plain``."""
    n = scores.shape[-1]
    lead = scores.shape[:-1]
    idx = torch.full((math.prod(lead), max_out), -1, dtype=torch.int32)
    flat = zip(boxes.reshape(-1, n, 4), scores.reshape(-1, n),
               valid.reshape(-1, n).bool())
    for img, (bx, sc, va) in enumerate(flat):
        alive = va & (sc > -torch.inf)
        order = torch.empty(int(alive.sum()), dtype=torch.int64)
        order[score_rank_plain(sc, alive)[alive]] = torch.arange(n)[alive]
        kept = scan_words(suppression_words(bx[order], iou_threshold, n),
                          max_out)
        idx[img, :len(kept)] = order[kept].int()
    idx = idx.view(lead + (max_out,))
    return idx, idx >= 0



def _edge_case(name):
    """(boxes, scores, valid, iou_threshold, max_out) of an edge case."""
    rng = np.random.RandomState(17 + len(name))
    if name == "signed_zero_ties":  # -0.0 == +0.0: the lowest index wins
        n = 90
        scores = rng.choice([-0.0, 0.0], n).astype(np.float32)
        scores[:6] = [-0.0, 0.0, -0.0, 0.0, 0.25, -0.0]
        bx = random_boxes(rng, n, span=25.0)
        bx[4] = [500.0, 500.0, 510.0, 510.0]  # the one 0.25 overlaps nothing
        return bx, scores, np.ones(n, bool), 0.3, 40
    if name == "plus_inf":  # +inf scores tie among themselves
        n = 70
        scores = rng.uniform(size=n).astype(np.float32)
        scores[rng.choice(n, 12, replace=False)] = np.inf
        scores[rng.choice(n, 5, replace=False)] = -np.inf
        return random_boxes(rng, n, span=30.0), scores, np.ones(n, bool), 0.4, 50
    if name == "nan_boxes":  # a NaN coordinate makes every IoU with it 0
        n = 80
        bx = random_boxes(rng, n, span=30.0)
        bx[rng.choice(n, 10, replace=False), rng.randint(0, 4, 10)] = np.nan
        bx[3] = np.nan
        scores = rng.uniform(size=n).astype(np.float32)
        scores[3] = 2.0  # the first pick is an all-NaN box
        return bx, scores, np.ones(n, bool), 0.3, 60
    if name == "zero_area":  # zero width or height, and empty unions
        n = 60
        bx = random_boxes(rng, n, span=20.0)
        bx[::4, 2] = bx[::4, 0]
        bx[1::4, 3] = bx[1::4, 1]
        bx[5] = bx[9] = bx[13] = [4.0, 4.0, 4.0, 4.0]
        scores = rng.uniform(size=n).astype(np.float32)
        return bx, scores, np.ones(n, bool), 0.2, 60
    if name == "past_alive":  # max_out beyond the alive boxes: -1 padding
        n = 50
        return (random_boxes(rng, n, span=20.0),
                rng.uniform(size=n).astype(np.float32),
                rng.uniform(size=n) > 0.4, 0.5, 120)
    if name == "many_chunks":  # 300 boxes: five chunks, rows of five words
        n = 300
        return (random_boxes(rng, n, span=120.0),
                rng.uniform(size=n).astype(np.float32),
                rng.uniform(size=n) > 0.1, 0.5, 250)
    raise KeyError(name)


EDGE_CASES = ["signed_zero_ties", "plus_inf", "nan_boxes", "zero_area",
              "past_alive", "many_chunks"]


def _case(name):
    return _edge_case(name) if name in EDGE_CASES else _nms_case(name)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("case", NMS_CASES + EDGE_CASES)
def test_route_l_replay_matches_jax_and_pallas_interpret(case):
    """Route L's replay and the twin: idx and keep identical to the JAX
    oracle and to the Pallas kernel in interpret mode."""
    bx, sc, va, thr, max_out = _case(case)
    jb, js, jv = jnp.asarray(bx), jnp.asarray(sc), jnp.asarray(va)
    refs = [jnms.nms(jb, js, thr, max_out, valid=jv),
            nms_pallas(jb, js, thr, max_out, valid=jv, interpret=True)]
    for fn in (greedy_nms_sorted_plain, cuda_nms.greedy_nms_plain):
        got_i, got_k = fn(_t(bx), _t(sc), _t(va), thr, max_out)
        assert got_i.dtype == torch.int32 and got_k.dtype == torch.bool
        for want_i, want_k in refs:
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
            np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    if case == "past_alive":
        assert (got_i.numpy()[int(va.sum()):] == -1).all()
    if case == "signed_zero_ties":
        assert got_i[0] == 4 and got_i[1] == 0  # 0.25, then -0.0 at index 0


def test_route_l_replay_batches_images():
    """B = 3 (one image all invalid): each image's picks equal the JAX
    oracle's; the replay and the twin agree on the whole batch."""
    cases = [_edge_case("plus_inf"), _edge_case("zero_area"),
             _nms_case("random")]
    n = 60
    bx = np.stack([c[0][:n] for c in cases])
    sc = np.stack([c[1][:n] for c in cases])
    va = np.stack([c[2][:n] for c in cases])
    va[2] = False
    got_i, got_k = greedy_nms_sorted_plain(_t(bx), _t(sc), _t(va), 0.4, 45)
    assert got_i.shape == got_k.shape == (3, 45)
    for i in range(3):
        want_i, want_k = jnms.nms(jnp.asarray(bx[i]), jnp.asarray(sc[i]), 0.4,
                                  45, valid=jnp.asarray(va[i]))
        np.testing.assert_array_equal(got_i[i].numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_k[i].numpy(), np.asarray(want_k))
    assert (got_i[2] == -1).all() and not got_k[2].any()
    twin_i, twin_k = cuda_nms.greedy_nms_plain(_t(bx), _t(sc), _t(va), 0.4, 45)
    assert torch.equal(got_i, twin_i) and torch.equal(got_k, twin_k)


def test_rank_by_counting_is_the_stable_score_order():
    """Rank (a): alive boxes get the places 0..M-1 of the order by score
    descending, then index ascending, with -0.0 equal to +0.0."""
    bx, sc, va, _, _ = _edge_case("signed_zero_ties")
    sc[7:20:3] = np.inf
    va[::7] = False
    alive = _t(va) & (_t(sc) > -torch.inf)
    rank = score_rank_plain(_t(sc), alive)
    order = sorted(np.flatnonzero(va), key=lambda i: (-float(sc[i]), i))
    assert [int(rank[i]) for i in order] == list(range(len(order)))


def test_suppression_words_hold_one_bit_a_later_box():
    """Mask (b): bit k of word c of row i is the suppression of box 64c + k
    by box i, set only for later boxes; words past the boxes are 0."""
    bx, sc, va, thr, _ = _edge_case("many_chunks")
    sb = _t(bx)[:150]
    words = suppression_words(sb, thr, 300)
    assert words.shape == (150, 5) and words.dtype == torch.int64
    iou = cuda_nms.iou_one_vs_all(sb, sb)
    for i in (0, 63, 64, 100, 149):
        row = [w & ((1 << 64) - 1) for w in words[i].tolist()]
        for j in range(300):
            bit = (row[j // 64] >> (j % 64)) & 1
            want = j > i and j < 150 and not bool(iou[i, j] <= thr)
            assert bit == want, (i, j)


@pytest.mark.parametrize("n,words,blocks", [(1, 1, 1), (64, 1, 1),
                                            (65, 2, 3), (512, 8, 36),
                                            (4336, 68, 2346),
                                            (16384, 256, 32896)])
def test_mask_grid(n, words, blocks):
    assert cuda_nms.mask_grid(n) == (words, blocks)


@pytest.mark.parametrize("tiles", [1, 2, 3, 8, 68, 256])
def test_tile_pairs_cover_the_upper_triangle_row_by_row(tiles):
    """The mask kernel's block → (row tile, column tile) map visits every
    pair with column ≥ row once, in row-major order."""
    got = [tile_pair(p, tiles) for p in range(cuda_nms.mask_grid(tiles * 64)[1])]
    assert got == [(r, c) for r in range(tiles) for c in range(r, tiles)]


@pytest.mark.parametrize("b,n", [(1, 4336), (1, 16384), (3, 777)])
def test_workspace_layout(b, n):
    """Route L's workspace: four pieces at 256-byte aligned offsets in
    order, each as large as its tensor; the mask is 8 * n * ceil(n/64)
    bytes an image (2.36 MB at 4336 boxes, 33.5 MB at 16384)."""
    offsets, size = cuda_nms.workspace_layout(b, n)
    words = -(-n // 64)
    need = {"sorted_box": 16 * b * n, "sorted_idx": 4 * b * n, "count": 4 * b,
            "mask": 8 * b * n * words}
    names = list(need)
    assert list(offsets) == names
    assert all(offsets[k] % 256 == 0 for k in names)
    for here, nxt in zip(names, names[1:]):
        assert offsets[nxt] >= offsets[here] + need[here]
    assert size >= offsets["mask"] + need["mask"] and size % 256 == 0
    if (b, n) == (1, 4336):
        assert need["mask"] == 2_358_784
    if (b, n) == (1, 16384):
        assert need["mask"] == 33_554_432


@pytest.mark.parametrize("n,max_out,route", [
    (512, 1, "s"), (512, 4, "s"), (4336, 512, "l"), (2000, 300, "l"),
    (16384, 64, "l"), (512, 8, "s"), (512, 9, "l"), (4336, 8, "s"),
    (4336, 9, "l"), (16384, 32, "s"), (16384, 33, "l")])
def test_route_rule(n, max_out, route):
    """The detection path's calls (512, 1) take route S; the greedy RPN's
    and the other many-pick shapes take route L; the crossover sits at 8
    picks up to N = 4336 and at N / 512 picks above."""
    assert cuda_nms.nms_route(n, max_out) == route


def test_cpu_tensors_take_the_twin_on_either_route():
    """A forced route on CPU tensors still computes the twin and counts
    nothing."""
    bx, sc, va, thr, max_out = _nms_case("random")
    cuda_nms.reset_launch_counts()
    want = cuda_nms.greedy_nms_plain(_t(bx), _t(sc), _t(va), thr, max_out)
    for route in cuda_nms.ROUTES:
        got = cuda_nms.greedy_nms(_t(bx), _t(sc), _t(va), thr, max_out,
                                  route=route)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cuda_nms.launch_counts() == {"greedy_nms": 0, "greedy_nms_s": 0,
                                        "greedy_nms_l": 0}


def _counting_nms(monkeypatch):
    """Replace the K3 wrapper by one that counts its calls by route (the
    wrapper itself counts only launches on the card)."""
    calls = {"greedy_nms": 0, "greedy_nms_s": 0, "greedy_nms_l": 0}
    greedy_nms = cuda_nms.greedy_nms

    def counting(boxes, scores, valid, thr, max_out, route=None):
        calls["greedy_nms"] += 1
        calls["greedy_nms_" + cuda_nms.nms_route(scores.shape[-1],
                                                 max_out)] += 1
        return greedy_nms(boxes, scores, valid, thr, max_out, route)

    monkeypatch.setattr(cuda_nms, "greedy_nms", counting)
    return calls


def _tiny_detection(greedy_rpn: bool, **ev_kw):
    """chip_smoke.detection_reference's tiny model and configuration with
    the default augmentation, in the fused window loop as
    chip_smoke.build_detection_path runs it."""
    from e_osvos_torch.data.transforms import AugmentConfig
    from e_osvos_torch.engine import (
        DetectionOneShotConfig, DetectionOneShotEvaluator,
    )
    from e_osvos_torch.meta_optim import MetaOptimConfig, init_meta_params
    from e_osvos_torch.models import MaskRCNN, RoIConfig, RPNConfig

    cfg = DetectionOneShotConfig(
        num_epochs=2, batch_size=3, online_adapt_step=2,
        online_adapt_epochs=2, proposal_aug_mode="EXTEND",
        augment=AugmentConfig(compute_dtype="float32"))
    model = MaskRCNN(arch="resnet10", backbone_norm="group4",
                     rpn=RPNConfig(anchor_sizes=(8, 16, 32, 64, 128),
                                   pre_nms_top_n=64, post_nms_top_n=32,
                                   batch_size_per_image=32,
                                   use_fast_nms=not greedy_rpn),
                     roi=RoIConfig(batch_size_per_image=16,
                                   detections_per_img=1), seed=5,
                     device="cpu")
    meta_cfg = MetaOptimConfig(init_lr=1e-3, use_log_init_lr=False)
    ev = DetectionOneShotEvaluator(model, meta_cfg, cfg, device="cpu",
                                   fused_ona=True, **ev_kw)
    return ev, init_meta_params(meta_cfg, model)


@pytest.mark.parametrize("greedy_rpn", [False, True])
def test_detection_sequence_nms_calls_match_the_smoke_formula(monkeypatch,
                                                             greedy_rpn):
    """A tiny detection sequence on the CPU makes exactly the K3 calls, by
    route, that ``chip_smoke.expected_detection_launches`` counts for the
    card: one a frame in the detection head on route S, and with the greedy
    RPN one a forward (over all its images) on route L."""
    import chip_smoke
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.ops import cuda_group_norm

    calls = _counting_nms(monkeypatch)
    T = 6
    index = SyntheticVOSIndex(num_sequences=1, num_frames=T, size=(64, 64),
                              seed=3)
    seq = index.sequences["seq00"]
    ev, meta_params = _tiny_detection(greedy_rpn)
    frames = torch.from_numpy(np.stack([index.get_image("seq00", t)
                                        for t in range(T)]))
    probs = ev._eval_object_group(
        index, seq, frames, seq.object_groups[0], meta_params,
        torch.Generator().manual_seed(0), None)
    assert probs.shape == (T, 64, 64)
    want = chip_smoke.expected_detection_launches(
        ev.cfg, T, 0, cuda_group_norm.LAUNCHES_PER_CALL, greedy_rpn)
    assert calls == {k: want[k] for k in calls}
    # 6 frames; 2 fine-tune steps and 4 refit steps, one forward each
    assert calls["greedy_nms_s"] == 6
    assert calls["greedy_nms_l"] == (12 if greedy_rpn else 0)


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("greedy_rpn", [False, True])
def test_two_object_sequence_nms_calls_match_the_smoke_formula(
        monkeypatch, greedy_rpn, batched):
    """``eval_sequence`` of a tiny 2-object sequence on the CPU makes the K3
    calls that ``expected_detection_launches(objects=2, batched=...)``
    counts: batched, each call serves both objects (the detection head's
    over ``[2, N, 4]``, the greedy RPN's over every image of both); in turn,
    twice one object's."""
    import chip_smoke
    from e_osvos_torch.data.synthetic import SyntheticVOSIndex
    from e_osvos_torch.ops import cuda_group_norm

    calls = _counting_nms(monkeypatch)
    T = 5
    index = SyntheticVOSIndex(num_sequences=1, num_frames=T, size=(64, 64),
                              num_objects=2, seed=1)
    assert len(index.sequences["seq00"].object_groups) == 2
    ev, meta_params = _tiny_detection(greedy_rpn, batch_objects=batched)
    res = ev.eval_sequence(index, "seq00", meta_params, 0)
    assert tuple(res["probs"].shape) == (2, T, 64, 64)
    want = chip_smoke.expected_detection_launches(
        ev.cfg, T, 0, cuda_group_norm.LAUNCHES_PER_CALL, greedy_rpn,
        objects=2, batched=batched)
    assert calls == {k: want[k] for k in calls}
    # 2 windows of 2 inferred frames; 2 fine-tune steps and 2 refit steps
    # (one refit), one forward each, for each object in turn
    times = 1 if batched else 2
    assert calls["greedy_nms_s"] == 4 * times
    assert calls["greedy_nms_l"] == (8 * times if greedy_rpn else 0)
