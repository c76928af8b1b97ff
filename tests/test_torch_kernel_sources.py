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


def test_occupancy_names_match_the_kernel_source():
    """mk.occupancy's names are mk_occupancy's cases, each kernel of the
    name queried with its block (SORT_TILE threads for the sorted ones) at
    the format of index which / 8, and mk.KERNEL_FORMATS lists the formats
    in the order of the source's FMT_KERNEL_AT, the classic rows first."""
    src = (build.CSRC / "megakernel.cu").read_text()
    for name, which in mk._OCCUPANCY_OF.items():
        threads = "kSortTile" if name.endswith("_sorted") else "kThreads"
        assert f"case {which}: return occupancy(FMT_KERNEL_AT(f, {name}_kernel), {threads}," in src, name
    assert len(mk._OCCUPANCY_OF) == 7
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
