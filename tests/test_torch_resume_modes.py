"""K2's two modes (csrc/megakernel.cu, the note at K2), what the CPU can
check of them: the threshold that picks the mode from the count of a
launch's going paths, the survivor scan's plain version (the count and the
list of going lanes K2 reads where no count is handed to it), the count
the compaction phases hand to K2 (their alive lanes, which they put first:
K2 counts min(it, N), the going paths of the cut input, never n_alive
before the cut) with no host read on the way, and the wrapper's mode and
survivors arguments. The kernels themselves, both modes on every
instantiation against the plain version, run on the card
(tests/test_torch_cuda.py -k resume_modes)."""

import numpy as np
import pytest
import torch

from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.scene.compile import compile_scene
from hijiki_tpu_torch.scene.obj import load_obj_scene
from torch_port_helpers import MESHBOX_SMALL


def _ms(**launch):
    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    return mk.launch_scene(mk.mega_scene(compile_scene(s), 16, 16, "cpu"), **launch)


def _state(n, alive_frac, seed, cap=12):
    """A packed state of n lanes, a seeded scatter of them alive, some of
    those at or past ``cap`` (not going), and NaN, inf and 1e30 origins."""
    g = np.random.default_rng(seed)
    st = g.standard_normal((mk.N_STATE, n)).astype(np.float32)
    st[0] = (g.random(n) < alive_frac).astype(np.float32)
    st[1] = g.integers(0, cap + 3, n).astype(np.float32)
    st[2, ::7] = np.nan
    st[3, 1::7] = np.inf
    st[4, 2::7] = 1e30
    return torch.from_numpy(st)


@pytest.mark.parametrize("mode,n,warps,want", [("auto", 4096, 2112, 2112), ("auto", 100, 2112, 2112),
                                               ("thread", 4096, 2112, -1), ("tail", 4096, 2112, 4096),
                                               ("tail", 1, 0, 1)])
def test_resume_threshold(mode, n, warps, want):
    """The auto threshold is the tail mode's resident warps; a forced mode
    sets it past every count (-1: thread; n: tail)."""
    assert mk.resume_threshold(mode, n, warps) == want


def test_resume_threshold_rejects_unknown_modes():
    with pytest.raises(ValueError):
        mk.resume_threshold("warp", 10, 10)


@pytest.mark.parametrize("count,thr,want", [(0, 2112, "tail"), (1, 2112, "tail"), (2111, 2112, "tail"),
                                            (2112, 2112, "tail"), (2113, 2112, "thread"),
                                            (0, -1, "thread"), (4096, 4096, "tail")])
def test_resume_mode_at_the_threshold(count, thr, want):
    """The tail mode runs at or below the threshold, the thread mode above
    it; a count just below, at and just above it."""
    assert mk.resume_mode(count, thr) == want


@pytest.mark.parametrize("thr", [-1, 0, 3, 50, 4096])
@pytest.mark.parametrize("alive_frac", [0.0, 1 / 3, 1.0])
def test_resume_survivors_plain_counts_and_lists_the_going_lanes(thr, alive_frac):
    """The scan's plain version: the count of lanes alive and under the cap
    (scattered, not a prefix; alive lanes at the cap and NaN/inf/1e30
    origins included), the mode word 0, then the going lanes ascending, as
    many as min(n, max(thr, 0)) hold."""
    n, cap = 997, 12
    st = _state(n, alive_frac, seed=int(alive_frac * 3) + 7, cap=cap)
    work = mk.resume_survivors(st, cap, thr)  # a CPU tensor: the plain version
    going = np.flatnonzero((st[0].numpy() > 0) & (st[1].numpy() < cap))
    cap_list = min(n, max(thr, 0))
    assert work.dtype == torch.int32 and work.shape == (2 + cap_list,)
    assert int(work[0]) == going.size and int(work[1]) == 0
    listed = work[2:2 + min(going.size, cap_list)].numpy()
    np.testing.assert_array_equal(listed, going[:cap_list])
    if 0 < alive_frac < 1 and going.size:
        assert going[-1] >= going.size  # scattered: not the prefix of the lanes


def test_compaction_hands_k2_the_cut_count_without_host_reads(monkeypatch):
    """render_waves' compaction phases hand K2 their count of alive lanes
    (``survivors``, a device int64) with the alive lanes first: K2's count,
    min(survivors, N), is the cut state's going paths (the survivor scan's
    count of it), and they are its first lanes; n_alive before the cut is
    larger where the cut drops paths. Nothing on the way reads a tensor
    back to the host (.item(), .cpu(), .tolist() raise)."""
    ms = _ms()
    n, caps, shrinks = 4096, [12, 48], [2, 4]
    flat = _state(n, 0.7, seed=3, cap=5)
    flat[1] = 5.0  # every path stopped at the camera launch's cap
    rng = torch.arange(n, dtype=torch.int32)
    seen = []

    def fake_resume(ms_, st, rng_, cap, lane_sort=False, survivors=None):
        assert survivors.dtype == torch.int64 and survivors.numel() == 1
        work = mk.resume_survivors(st, cap, st.shape[1])
        seen.append((st.clone(), cap, work[0].clone(), torch.clamp_max(survivors, st.shape[1])))
        out = st.clone()
        out[0, 1::2] = 0.0  # half the lanes die; the others stop at the cap
        out[1] = float(cap)
        return out, rng_

    def no_host(*a, **k):
        raise AssertionError("a host read on the compaction's path")

    res, res_state = mk._with_trash_column(torch.zeros((len(mk._RESULT_CH), n)), torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(mk, "megakernel_resume", fake_resume)
    with monkeypatch.context() as m:
        for name in ("item", "cpu", "tolist"):
            m.setattr(torch.Tensor, name, no_host)
        mk._run_compaction_phases(ms, caps, shrinks, flat, rng, torch.arange(n), res, res_state)
    assert [cap for _, cap, _, _ in seen] == caps
    alive_before = int((flat[0] > 0).sum())
    for (st, cap, count, handed), shrink, n_in in zip(seen, shrinks, (n, n // 2)):
        n_next = max(mk.TILE, -(-(n_in // shrink) // mk.TILE) * mk.TILE)
        going = (st[0] > 0) & (st[1] < cap)
        assert st.shape[1] == n_next
        assert int(count) == int(going.sum()) == int(handed)
        assert bool(going[:int(handed)].all()) and not bool(going[int(handed):].any())
    first = int(seen[0][3])
    assert first == min(alive_before, seen[0][0].shape[1]) and first < alive_before


def test_wrapper_mode_argument_on_the_cpu():
    """On the CPU every mode runs the plain version (the same outputs); an
    unknown mode, and a forced mode with the lane sort, raise."""
    ms = _ms()
    st = _state(300, 0.5, seed=11, cap=6)
    st[1] = torch.clamp(st[1], max=5.0)
    st[2:5] = torch.nan_to_num(st[2:5], nan=0.1, posinf=0.2)
    rng = torch.arange(1, 301, dtype=torch.int32)
    want = mk.megakernel_resume_plain(ms, st, rng, 6)
    for mode in mk.RESUME_MODES:
        got = mk.megakernel_resume(ms, st, rng, 6, mode=mode)
        assert all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        mk.megakernel_resume(ms, st, rng, 6, mode="warp")
    with pytest.raises(ValueError):
        mk.megakernel_resume(ms, st, rng, 6, lane_sort=True, mode="tail")
    # the compaction's count (a hint) changes nothing, right or wrong
    for hint in (int((st[0] > 0).sum()), 0, 300):
        got = mk.megakernel_resume(ms, st, rng, 6, survivors=torch.tensor(hint))
        assert all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))


@pytest.mark.parametrize("launch,want", [({}, "classic"), (dict(shadow_cache=True), "classic_cache"),
                                         (dict(shadow_tbl=True), "shadow_tbl")])
def test_format_of_names_the_instantiation(launch, want):
    """mk.format_of: the KERNEL_FORMATS key (fmt_index's instantiation)
    that a launch on the scene runs, whose tail-mode warps are its
    threshold."""
    assert mk.format_of(_ms(**launch)) == want
