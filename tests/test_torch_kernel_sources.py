"""What the card tools read out of the kernel sources, checked on the CPU.

The A/B tool (tools/ab_megakernel_torch.py) builds its per-part variants
of this tree by rewriting copies of csrc/ (``PATH_VARIANTS``), and
tools/probe_sort_tile.py rewrites megakernel.cu's sort lines: each text
they replace must still occur in the sources as often as they expect, or
the card run stops. ``build.spill_stores`` reads ptxas' report, which
``mk.occupancy`` passes on as a kernel's spill bytes. ctypes calls a C
entry with the argument types of ``build.SIGNATURES`` whatever the entry
takes, so each entry's parameter count is read off its source here."""

import re
import sys
from pathlib import Path

import pytest

from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.probes import ablate_walker as pab
from hijiki_tpu_torch.utils import build

TOOLS = Path(__file__).resolve().parents[1] / "tools"
sys.path.insert(0, str(TOOLS))

import ab_megakernel_torch as ab  # noqa: E402
import probe_sort_tile  # noqa: E402

OWN_VARIANTS = sorted(v for v, (base, _, _) in ab.PATH_VARIANTS.items() if base == "new")


@pytest.mark.parametrize("variant", OWN_VARIANTS)
def test_ab_variants_apply_to_the_sources(variant):
    """Every text a variant of this tree replaces occurs in csrc/ as often
    as the variant says, and the variant changes the file."""
    _, edits, _ = ab.PATH_VARIANTS[variant]
    for fname, subs in edits.items():
        text = (build.CSRC / fname).read_text()
        for old, new, times in subs:
            assert text.count(old) == times, (variant, fname, old)
            assert new != old


def test_resume_group_covers_every_k2_instantiation():
    """The A/B tool's resume group (its default --resume-formats) times K2
    on every instantiation of the kernel (mk.KERNEL_FORMATS, in its order)
    and on (p)."""
    assert ab.RESUME_FORMATS == (*mk.KERNEL_FORMATS, "(p)")


def test_probe_sort_tile_lines_occur_once():
    """tools/probe_sort_tile.py's tile, key and sort lines each occur once
    in megakernel.cu, and its lockstep key removes the whole exchange."""
    src = (build.CSRC / "megakernel.cu").read_text()
    for line in (probe_sort_tile.TILE_LINE, probe_sort_tile.KEY_LINE, probe_sort_tile.SORT_LINES):
        assert src.count(line) == 1, line
    assert "block_sort_packed" in probe_sort_tile.SORT_LINES and "get_path" in probe_sort_tile.SORT_LINES


REPORT = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122mk_start_sorted_kernelENS_5SceneEPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122mk_start_sorted_kernelENS_5SceneEPKf
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115mk_start_kernelENS_5SceneEPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115mk_start_kernelENS_5SceneEPKf
    40 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 80 registers, used 0 barriers, 40 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115mk_tiles_kernelILi0ELb0EEEvNS_5SceneEPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115mk_tiles_kernelILi0ELb0EEEvNS_5SceneEPKf
    40 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 80 registers, used 0 barriers, 40 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115mk_tiles_kernelILi12ELb0EEEvNS_5SceneEPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115mk_tiles_kernelILi12ELb0EEEvNS_5SceneEPKf
    48 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 80 registers, used 0 barriers, 48 bytes cumulative stack size
"""


@pytest.mark.parametrize("kernel,targs,spill", [("mk_start_sorted_kernel", "", 0),
                                                ("mk_start_kernel", "", 4),
                                                ("mk_tiles_kernel", "ILi0ELb0E", 8),
                                                ("mk_tiles_kernel", "ILi12ELb0E", 16)])
def test_spill_stores_reads_the_report(kernel, targs, spill):
    """Each kernel's spill stores by its own name and template arguments:
    mk_start_kernel is not read off mk_start_sorted_kernel's lines, nor one
    instantiation off another's, and a kernel the report lacks raises (the
    template's name alone names none of its instantiations)."""
    assert build.spill_stores(REPORT, kernel, targs) == spill
    with pytest.raises(KeyError):
        build.spill_stores(REPORT, "mk_resume_kernel")
    with pytest.raises(KeyError):
        build.spill_stores(REPORT, "mk_tiles_kernel")
    with pytest.raises(KeyError):
        build.spill_stores(REPORT, "mk_tiles_kernel", "ILi4ELb0E")


@pytest.mark.parametrize("kernel,targs,want", [("mk_start_sorted_kernel", "", (80, 0)),
                                               ("mk_start_kernel", "", (80, 4)),
                                               ("mk_tiles_kernel", "ILi12ELb0E", (80, 16))])
def test_ptxas_of_reads_registers_and_spills(kernel, targs, want):
    """``build.ptxas_of`` gives the registers of the same function whose
    spill stores it gives, and raises where the report lacks it."""
    assert build.ptxas_of(REPORT, kernel, targs) == want
    report = REPORT.replace("Used 80 registers, used 0 barriers, 40 bytes cumulative stack size\n"
                            "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115mk_tiles",
                            "Used 72 registers, used 0 barriers, 40 bytes cumulative stack size\n"
                            "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115mk_tiles")
    assert build.ptxas_of(report, "mk_start_kernel") == (72, 4)
    assert build.ptxas_of(report, "mk_start_sorted_kernel") == (80, 0)
    with pytest.raises(KeyError):
        build.ptxas_of(REPORT, "mk_tiles_kernel", "ILi4ELb0E")


def test_occupancy_names_match_the_kernel_source():
    """mk.occupancy's names are mk_occupancy's cases, each kernel of the
    name queried with its block (SORT_TILE threads for the sorted ones) at
    the format of index which / 8, and mk.KERNEL_FORMATS lists the formats
    in the order of the source's FMT_KERNEL_AT, the classic rows first."""
    src = (build.CSRC / "megakernel.cu").read_text()
    for name, which in mk._OCCUPANCY_OF.items():
        threads = "kSortTile" if name.endswith("_sorted") else "kThreads"
        assert f"case {which}: return occupancy(FMT_KERNEL_AT(f, {name}_kernel), {threads}," in src, name
    assert len(mk._OCCUPANCY_OF) == 8
    assert f"constexpr int kFormats = {len(mk.KERNEL_FORMATS)};" in src
    for f, (packed, sh, cache) in enumerate(mk.KERNEL_FORMATS.values()):
        inst = f"&k<{packed}, {'true' if sh else 'false'}, {'true' if cache else 'false'}>"
        pat = rf"\(f\) == {f}\s+\? {re.escape(inst)}" if f else rf":\s+{re.escape(inst)}\)"
        assert re.search(pat, src), (f, inst)


def _entries():
    """{C entry name: its parameter count} of every ``extern "C"`` function
    in csrc/*.cu, with the sources' argument macros (SCENE_ARGS,
    START_ARGS, ...) expanded."""
    macros, entries = {}, {}
    for f in build.sources():
        text = f.read_text()
        for m in re.finditer(r"^#define (\w+)((?:[^\n]*\\\n)*[^\n]*)", text, re.M):
            macros[m.group(1)] = m.group(2).replace("\\\n", " ")
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            entries[m.group(1)] = m.group(2)
    out = {}
    for name, params in entries.items():
        for _ in range(4):  # macros inside macros
            params = re.sub(r"\b[A-Z_]+_ARGS\b", lambda m: macros[m.group(0)], params)
        out[name] = len([p for p in params.split(",") if p.strip()])
    return out


ENTRIES = _entries()


def test_every_entry_has_a_signature():
    """The C entries of csrc/*.cu are the keys of build.SIGNATURES."""
    assert sorted(ENTRIES) == sorted(build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_entry_arity_matches_its_signature(name):
    """Each C entry takes as many parameters as build.SIGNATURES gives
    ctypes (a work counter added to an entry, such as K5's, or dropped,
    shows here)."""
    assert ENTRIES.get(name) == len(build.SIGNATURES[name]), name


def _body(src: str, signature: str) -> str:
    """The text between the braces of the function whose declaration
    contains ``signature``."""
    start = src.index("{", src.index(signature))
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start + 1:i]
    raise ValueError(f"unbalanced braces after {signature}")


def test_walk_ablate_reads_rows_as_the_render_walk():
    """K10a's body loads a row as the render walk does (row.cuh::row4):
    columns 0-11 in three 128-bit loads, the normal's float4 only in the
    prim part on a prim row (or, without fetch, once for row 0 when it is
    one); no row is read as 14 scalars any more. A variant without the prim
    test folds the columns only the prim and slab tests read into `keep`,
    and one without the slab test votes on an opaque false, both zero on a
    one-dimensional grid (blockIdx.z), so the compiler narrows or drops
    none of those loads."""
    src = (build.CSRC / "probe_walk.cu").read_text()
    assert "load_row" not in src and "struct Row " not in src and "select_row" not in src
    assert "return {row4(r, 0), row4(r, 4), row4(r, 8)};" in _body(src, "Head fetch_head(")
    body = _body(src, "walk_ablate_kernel(")
    assert re.search(r"\b(rows|r|ra|rb)\[", body) is None  # no scalar load of a row
    assert body.count("fetch_head(") == 4  # row 0, the cursor's row, both successors
    assert body.count("row4(") == 2
    assert "if constexpr (!fetch || prefetch) h = fetch_head(r);" in body
    prim = _body(body, "if constexpr (prim)")
    assert "const float4 nr = fetch ? row4(r, 28) : n0;" in _body(prim, "if (is_prim)")
    assert "n0 = row4(r, 28);" in _body(body, "if constexpr (!fetch && prim)")
    assert "const unsigned zero = blockIdx.z;" in body and "bool slab = zero != 0u;" in body
    noprim = _body(body, "if constexpr (!prim)")
    assert "keep ^= bits(h.b.z) ^ bits(h.b.w) ^ bits(h.c.x);" in noprim
    assert all(f"bits(h.{c})" in noprim for c in ("a.x", "a.y", "a.z", "a.w", "b.x", "b.y"))
    assert "cur ^ static_cast<int>(keep & zero)" in body
    launch = (build.CSRC / "probe.cuh").read_text()
    assert "kernel<<<(threads + block - 1) / block, block, smem," in launch  # a 1-D grid


@pytest.mark.parametrize("variant", sorted(pab.VARIANTS))
def test_walk_ablate_row_loads_count_the_source(variant):
    """``pab.row_loads``, the 128-bit loads the card's SASS must hold, is
    the source's count: row 0's three float4s unless each step loads its
    row, three a step or six with prefetch, one for the normal."""
    cfg = {p: pab.VARIANTS[variant].get(p, True) for p in pab.PARTS}
    want = 3 * (not cfg["fetch"] or cfg["prefetch"]) + cfg["fetch"] * (6 if cfg["prefetch"] else 3)
    assert pab.row_loads(pab.variant_flags(pab.VARIANTS[variant])) == want + cfg["prim"]


def _sass(loads, loop=(0, 0)):
    """A fake sass_functions entry: (opcode, rest) pairs and one loop."""
    return ([(op, " R0, desc[UR4][R2.64] ") for op in loads], [loop], "")


def test_check_row_loads_flags_a_narrowed_row(monkeypatch):
    """check_row_loads passes SASS that loads rows 128 bits wide with the
    rays' scalar loads outside the loop, also where the compiler copied a
    loop's loads, and names an instantiation whose loop loads narrower
    (ptxas' narrowed float4) or that holds fewer 128-bit loads than its
    source (a dropped one), and a missing instantiation."""
    from hijiki_tpu_torch import probes
    from hijiki_tpu_torch.probes import GROUPS

    def fake(narrowed=None, short=None, missing=None, copied=None):
        out = {}
        for v, cfg in pab.VARIANTS.items():
            flags = pab.variant_flags(cfg)
            for g in GROUPS:
                name = f"_ZN12_GLOBAL__N_118walk_ablate_kernelILi{flags}ELi{g}EEEvPKfiS2_S2_iiPf"
                wide = ["LDG.E.128.CONSTANT"] * (pab.row_loads(flags) * (1 + (v == copied))
                                                 - (v == short))
                ops = ["LDG.E.CONSTANT"] * 6 + wide + ["BRA"]
                if v == narrowed:
                    ops = ops[:6] + ["LDG.E.64.CONSTANT"] + ops[7:]
                if v != missing:
                    out[name] = _sass(ops, (6, len(ops) - 1))
        return lambda kernel, lib=None: out

    for kw in ({}, dict(copied="onlyfetch")):
        monkeypatch.setattr(probes, "sass_functions", fake(**kw))
        loads = pab.check_row_loads()
        assert len(loads) == len(pab.VARIANTS) * len(GROUPS)
    for kw, what in ((dict(narrowed="noprim"), "1 of them in a loop"),
                     (dict(short="full"), "9 LDG.E.128 (the source has 10)"),
                     (dict(missing="nocount"), "20 instantiations")):
        monkeypatch.setattr(probes, "sass_functions", fake(**kw))
        with pytest.raises(RuntimeError, match=re.escape(what)):
            pab.check_row_loads()


def test_staged_chase_copy_paths():
    """K11a's staged_chase and staged_multi keep the per-lane cp.async copy
    (the bulk copy read slower on the card) and store a row a float4 a
    lane."""
    src = (build.CSRC / "probe_latency.cu").read_text()
    for kernel in ("staged_chase_kernel(", "staged_multi_kernel("):
        body = _body(src, kernel)
        assert "copy_rows(" in body and "store_row(" in body, kernel
        assert "o[c] = val" not in body
    assert "cp.async.cg.shared.global" in src and "cp.async.bulk.shared" not in src


def test_walk_loops_pick_the_innermost_loops_of_row_loads():
    """walk_probe.walk_loops: a head's back edges make one loop; of the
    loops that hold a 128-bit LDG, those holding no other such loop."""
    from hijiki_tpu_torch.probes import walk_probe as W

    ops = ["MOV", "LDG.E.128.CONSTANT", "FADD", "BRA", "LDG.E.128.CONSTANT", "LDG.E", "BRA",
           "LDG.E", "BRA", "EXIT"]
    code = [(op, "") for op in ops]
    # the walk: head 1, back edges at 3 and 6; the outer loop 0-8; a loop
    # 7-7 without a row load
    loops = [(1, 3), (1, 6), (0, 8), (7, 7)]
    assert W.walk_loops(code, loops) == [(1, 6)]
    assert W.walk_loops(code, [(0, 8)]) == [(0, 8)]
    assert W.walk_loops(code, [(7, 8)]) == []


def _fake_sass(local_at=None, drop=None, flat=None):
    """sass_functions' form for every packed walk of walk_probe.PACKED_KERNELS:
    a walk loop (a 128-bit row load, a narrower load, a back branch) after
    a frame's STL; ``local_at`` gets an LDL inside its walk loop, ``drop``
    is left out, ``flat`` has no loop."""
    from hijiki_tpu_torch.probes import walk_probe as W

    out = {}
    for kernel, targs in W.PACKED_KERNELS.items():
        for t in targs:
            if (kernel, t) == drop:
                continue
            ops = ["STL", "LDG.E.128.CONSTANT", "LDG.E.CONSTANT", "FADD", "BRA", "EXIT"]
            if (kernel, t) == local_at:
                ops.insert(3, "LDL")
            loops = [] if (kernel, t) == flat else [(1, ops.index("BRA"))]
            out[f"_Z{len(kernel)}{kernel}{t}EvNS_5SceneE"] = ([(op, "") for op in ops], loops, "")
    return out


@pytest.mark.parametrize("case", ["clean", "local", "missing", "no_loop"])
def test_check_packed_loads_holds_walk_loops(monkeypatch, case):
    """walk_probe.check_packed_loads counts each packed walk's loads and
    fails where an instantiation is missing or has no walk loop, and, held,
    where an LDL/STL lies in a walk loop; a frame's LDL/STL outside the
    walk loops is counted and allowed."""
    import hijiki_tpu_torch.probes as P
    from hijiki_tpu_torch.probes import walk_probe as W

    key = ("mk_start_kernel", "ILi4ELb0ELb1E")
    kw = {"local": dict(local_at=key), "missing": dict(drop=key), "no_loop": dict(flat=key)}
    monkeypatch.setattr(P, "sass_functions", lambda kernel, lib=None: _fake_sass(**kw.get(case, {})))
    if case != "clean":
        with pytest.raises(RuntimeError, match=key[0]):
            W.check_packed_loads()
    if case in ("missing", "no_loop"):  # not held either
        with pytest.raises(RuntimeError, match=key[0]):
            W.check_packed_loads(hold=False)
        return
    got = W.check_packed_loads(hold=case == "clean")
    assert len(got) == sum(map(len, W.PACKED_KERNELS.values()))
    local = int(case == "local")
    assert got[key] == (1, 1, local, 1 + local)


def test_any_hit_walks_stop_at_the_first_occluding_prim():
    """The packed walk's any-hit accept (walk.cuh packed_test<kFmt, true>)
    returns at the first prim with a hit below tmax; walk_packed takes it
    for an any hit under kStop and otherwise compares the tournament's t;
    the kernels set kStop (megakernel.cu kAnyStop) in the occlusion
    cache's instantiations but PACKED12's, in the walk and in
    row_occludes, and the dedicated shadow table's walk keeps the
    tournament."""
    walk = (build.CSRC / "walk.cuh").read_text()
    mega = (build.CSRC / "megakernel.cu").read_text()
    test = walk[walk.index("bool packed_test("):walk.index("// The stackless walk over rows")]
    assert "if constexpr (kAny) {\n      if (h && t < tmax) return true;" in test
    assert "if (h && (!bhit || t < pt))" in test
    body = walk[walk.index("__device__ float walk_packed("):]
    assert "if (kStop && kTest && any_hit) {\n      if (packed_test<kFmt, true>(" in body
    assert "packed_test<kFmt>(" in body
    assert "constexpr bool kAnyStop = kCache && kFmt != 12;" in mega
    occ = mega[mega.index("bool row_occludes("):mega.index("// any hit in [tmin, tmax)")]
    assert "if constexpr (kAnyStop<kFmt, true>)\n      return packed_test<kFmt, true>(" in occ
    any_hit = mega[mega.index("__device__ bool trace_any("):mega.index("// ----", mega.index("__device__ bool trace_any("))]
    assert "walk_packed<kFmt, true, 1, kAnyStop<kFmt, kCache>>(" in any_hit
    assert "walk_packed<3>(S.shadow_rows" in any_hit
