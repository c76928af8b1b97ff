"""The JAX package's call forms on the port: every public name of every
``hijiki_tpu`` module has its counterpart at the same path under
``hijiki_tpu_torch``, which accepts JAX's parameter names; the JAX forms of
the render entries, the sweep functions, the sharded sweeps and the single
names (``reconstruct_pallas``, ``sort_tile_by_key``, ``pad_rows_table``,
the rng's ``xp``, the resolvers) compute what the port's own forms compute.

Bounds. The JAX form of a render entry against the ``MegaScene`` form:
bit-equal in every output, for every value of the TPU walker's kwargs (the
per-thread walk reads none of them). Against ``hijiki_tpu``'s same call in
interpret mode, the bounds of tests/test_torch_megakernel.py and
test_torch_chained.py: >= 99.5% of paths with a bit-equal RNG and radiance
within rtol/atol 2e-3 (the silhouette/t-tie reroute class). The sweep and
sharded forms against the port's forms: bit-equal. ``reconstruct_pallas``
against JAX's: rtol 1e-5 / atol 1e-6 (tests/test_torch_reconstruct.py);
``sort_tile_by_key``, ``pad_rows_table`` and the numpy rng: bit-equal to
JAX's; the resolvers: equal to JAX's on the CPU backend with the HIJIKI_*
overrides unset, but for the chain default the port keeps (the card's)."""

import ast
import dataclasses
import gc
import importlib
import inspect
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hijiki_tpu.scene.compile import compile_scene as j_compile, scene_to_device as j_to_device
from hijiki_tpu.scene.obj import load_obj_scene as j_load
from hijiki_tpu_torch.ops import megakernel as mk
from hijiki_tpu_torch.ops import pallas_megakernel as pmk
from hijiki_tpu_torch.render import renderer as rnd
from hijiki_tpu_torch.render.blocks import BlockScheduler, per_pixel_seeds
from hijiki_tpu_torch.scene.compile import scene_to_device, to_device
from torch_port_helpers import MESHBOX_SMALL, frame_inputs, port_scene

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "hijiki_tpu"

# JAX/TPU plumbing with no port on purpose (ROADMAP.md Queue 1): the AOT
# executable cache, the libtpu flags and the shard_map checks
PLUMBING = {"utils/aot.py", "utils/cache.py", "utils/tpuenv.py", "utils/vma.py"}

# JAX names not carried over, each with why
EXCLUDED = {
    # the TPU kernel's tile of 8 packets of 128 rays: the CUDA walk has no
    # packet and takes any ray count
    ("ops/pallas_traverse.py", "SUBLANES"): "the TPU's tile of packets",
    ("ops/pallas_traverse.py", "TILE"): "the TPU's tile of packets",
    # aliases of jnp dtypes
    ("ops/pallas_megakernel.py", "f32"): "a jnp dtype alias",
    ("ops/pallas_sort.py", "i32"): "a jnp dtype alias",
    ("render/pallas_reconstruct.py", "f32"): "a jnp dtype alias",
    # the TPU's walker defaults and its HBM DMA row width
    ("ops/pallas_megakernel.py", "MEGA_PACKET_TPU"): "the TPU's packet width",
    ("ops/pallas_megakernel.py", "MEGA_GROUPS_TPU"): "the TPU's cursor groups",
    ("ops/pallas_megakernel.py", "CHAIN_SWEEPS_TPU"): "the TPU's; the card's is CHAIN_SWEEPS_CUDA",
    ("ops/pallas_megakernel.py", "HBM_ROW_WIDTH"): "the TPU's 128-lane DMA rows",
    # the Mosaic kernel's static config dict
    ("ops/pallas_megakernel.py", "base_cfg_nochain"): "the Mosaic kernel's config dict",
}

JAX_MODULES = sorted(
    p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py")
    if p.relative_to(JAX_PKG).as_posix() not in PLUMBING
)


def _params(fn: ast.FunctionDef, method: bool = False):
    """(positional names without a default, names to bind by keyword) of a
    JAX function: a caller passes the first positionally (as it passes the
    list of devices that takes the place of JAX's mesh), the rest by name."""
    a = fn.args
    pos = a.posonlyargs + a.args
    if method:
        pos = pos[1:]
    n_req = len(pos) - len(a.defaults)
    return [p.arg for p in pos[:n_req]], [p.arg for p in pos[n_req:] + a.kwonlyargs]


def _public(tree):
    """The public names a JAX module defines at its top level."""
    out = {}
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            out[n.name] = n
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for tgt in n.targets if isinstance(n, ast.Assign) else [n.target]:
                for e in tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]:
                    if isinstance(e, ast.Name):
                        out[e.id] = n
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _check_bind(port_fn, fn: ast.FunctionDef, what: str, method: bool = False):
    """``method``: JAX's function takes self (a constructor's signature,
    read from the port's class, has none; a method's, read from the class,
    has)."""
    req, named = _params(fn, method)
    sig = inspect.signature(port_fn)
    this = ["self"] if method and not inspect.isclass(port_fn) else []
    try:
        sig.bind(*this, *req, **{k: None for k in named})
    except TypeError as e:
        pytest.fail(f"{what}: JAX's parameters {req} + {named} do not bind: {e}")


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_jax_name_has_its_port(rel):
    """Every public name of the JAX module exists in the port's module at
    the same path, and accepts JAX's parameter names (a class: its
    constructor and each public method)."""
    tree = ast.parse((JAX_PKG / rel).read_text())
    mod = importlib.import_module("hijiki_tpu_torch." + rel[:-3].replace("/", "."))
    for name, node in _public(tree).items():
        if (rel, name) in EXCLUDED:
            assert not hasattr(mod, name), f"{rel}:{name} is ported: take it off the list"
            continue
        assert hasattr(mod, name), f"{rel}: {name} has no port"
        port = getattr(mod, name)
        if isinstance(node, ast.FunctionDef):
            _check_bind(port, node, f"{rel}:{name}")
        elif isinstance(node, ast.ClassDef):
            init = next((b for b in node.body
                         if isinstance(b, ast.FunctionDef) and b.name == "__init__"), None)
            if init is not None:
                _check_bind(port, init, f"{rel}:{name}()", method=True)
            for b in node.body:
                if not isinstance(b, ast.FunctionDef) or b.name.startswith("_"):
                    continue
                deco = {getattr(d, "id", getattr(d, "attr", "")) for d in b.decorator_list}
                if "property" in deco:
                    assert hasattr(port, b.name), f"{rel}: {name}.{b.name} has no port"
                    continue
                assert hasattr(port, b.name), f"{rel}: {name}.{b.name} has no port"
                static = inspect.getattr_static(port, b.name)
                bound = not isinstance(static, (classmethod, staticmethod))
                if bound:
                    _check_bind(getattr(port, b.name), b, f"{rel}:{name}.{b.name}", method=True)
                else:
                    req, named = _params(b, method="classmethod" in deco)
                    inspect.signature(getattr(port, b.name)).bind(*req, **{k: None for k in named})


def test_exclusions_name_jax_names():
    """Every excluded name is a public name of its JAX module (a stale entry
    would exempt nothing)."""
    for rel, name in EXCLUDED:
        assert name in _public(ast.parse((JAX_PKG / rel).read_text())), (rel, name)


# ----------------------------------------------------------------------------
# the render entries: JAX's form against the MegaScene form
# ----------------------------------------------------------------------------

W = H = 16
S = 2
WALKER = [
    ("interpret", True), ("packet", 1024), ("prefetch", False), ("spec", False),
    ("spec_resolve", True), ("table_in_hbm", True), ("groups", 4), ("group_octant", False),
    ("trunk_rows", 64), ("hbm_window", 4),
]


def _port_cs():
    from hijiki_tpu_torch.scene.compile import compile_scene
    from hijiki_tpu_torch.scene.obj import load_obj_scene

    s = load_obj_scene(MESHBOX_SMALL)
    s.put_cbox_spheres()
    return compile_scene(s)


@pytest.fixture(scope="module")
def cs():
    """The port's JAX-default compile of the meshbox with the spheres, as
    CPU tensors (``scene_to_device(cs, "cpu")``)."""
    return scene_to_device(_port_cs(), "cpu")


def _frame():
    px, py, seeds = frame_inputs(W, H, 0.37, 0.61, 2654435761)
    return torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(seeds.view(np.int32))


def _chain_frame():
    rng = np.random.default_rng(5)
    px, py, sd = _frame()
    offs = torch.from_numpy(rng.random((S, 2), dtype=np.float32))
    pxs = torch.stack([px + offs[s, 0] for s in range(S)])
    pys = torch.stack([py + offs[s, 1] for s in range(S)])
    seeds = torch.stack([sd + 977 * s for s in range(S)])
    return pxs, pys, seeds


ENTRIES = {
    "render_tiles": (mk.render_tiles, _frame, dict(max_bounces=24)),
    "render_waves": (mk.render_waves, _frame, dict(max_bounces=24, phase_bounces=(6, 12))),
    "render_waves_chained": (mk.render_waves_chained, _chain_frame,
                             dict(max_bounces=24, chain_cap=4)),
}


@pytest.fixture(scope="module")
def megascene_outputs(cs):
    """Each entry's outputs in the port's MegaScene form."""
    ms = mk.mega_scene(cs, W, H, "cpu")
    return {name: fn(ms, *inputs(), **kw) for name, (fn, inputs, kw) in ENTRIES.items()}


def _equal(a, b):
    assert len(a) == len(b)
    for k, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"output {k} differs"


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("kwarg,value", WALKER)
def test_jax_form_equals_megascene_form(cs, megascene_outputs, entry, kwarg, value):
    """The JAX form on a ``scene_to_device(cs, "cpu")`` scene, with one
    walker kwarg off its default, is the MegaScene form bit for bit."""
    fn, inputs, kw = ENTRIES[entry]
    got = getattr(pmk, entry)(cs, *inputs(), width=W, height=H, **kw, **{kwarg: value})
    _equal(got, megascene_outputs[entry])


def test_jax_form_takes_uint32_seeds(cs, megascene_outputs):
    px, py, sd = _frame()
    got = pmk.render_waves(cs, px, py, sd.view(torch.uint32), width=W, height=H,
                           **ENTRIES["render_waves"][2])
    _equal(got, megascene_outputs["render_waves"])


def test_walker_raises_kept_and_dropped(cs):
    """The raises that concern the request stay (the lane sort's 128-lane
    packet, ``_check_shadow_tbl``); the TPU layout's are dropped: groups
    that do not divide the packet, groups without the spec walker, and a
    ray count off a multiple of 8 * packet all render."""
    px, py, sd = _frame()
    with pytest.raises(ValueError, match="128-lane packets"):
        pmk.render_waves(cs, px, py, sd, width=W, height=H, lane_sort=True, packet=1024)
    with pytest.raises(ValueError, match="VMEM-only"):
        pmk.render_waves(cs, px, py, sd, width=W, height=H, shadow_tbl=True, table_in_hbm=True)
    with pytest.raises(ValueError, match="MAIN-table"):
        pmk.render_tiles(cs, px, py, sd, width=W, height=H, shadow_tbl=True, shadow_cache=True)
    n = 300  # not a multiple of 8 * 128
    a = pmk.render_tiles(cs, px[:n], py[:n], sd[:n], width=W, height=H, max_bounces=6,
                         groups=3, spec=False, packet=128)
    b = pmk.render_tiles(cs, px[:n], py[:n], sd[:n], width=W, height=H, max_bounces=6)
    _equal(a, b)


def test_scene_of_checks():
    """A CompiledScene needs the image size; a MegaScene keeps its own and
    refuses another; a scene on another device than the inputs raises."""
    cpu = scene_to_device(_port_cs(), "cpu")
    px, py, sd = _frame()
    with pytest.raises(TypeError, match="width"):
        pmk.render_tiles(cpu, px, py, sd)
    ms = mk.mega_scene(cpu, W, H, "cpu")
    with pytest.raises(ValueError, match="baked for width"):
        pmk.render_tiles(ms, px, py, sd, width=2 * W, height=H)
    pmk.render_tiles(ms, px, py, sd, width=W, height=H, max_bounces=2)  # the bake's own size
    meta = to_device(_port_cs(), "meta")
    with pytest.raises(ValueError, match="lies on meta"):
        pmk.render_tiles(meta, px, py, sd, width=W, height=H)


def test_bake_once_per_scene_and_size():
    """The JAX form bakes a scene once per (scene object, size, device): a
    repeated call bakes nothing, another size or another scene object
    (equal fields) bakes again, a MegaScene never bakes, and a collected
    scene leaves no entry behind."""
    cpu = scene_to_device(_port_cs(), "cpu")
    px, py, sd = _frame()
    mk.BAKES["mega_scene"] = 0
    kw = dict(width=W, height=H, max_bounces=2)
    for _ in range(3):
        pmk.render_waves(cpu, px, py, sd, **kw)
    assert mk.BAKES["mega_scene"] == 1
    pmk.render_tiles(cpu, px, py, sd, **kw)  # any entry shares the bake
    assert mk.BAKES["mega_scene"] == 1
    pmk.render_tiles(cpu, px[:64], py[:64], sd[:64], width=8, height=8, max_bounces=2)
    assert mk.BAKES["mega_scene"] == 2
    other = dataclasses.replace(cpu)
    pmk.render_tiles(other, px, py, sd, **kw)
    assert mk.BAKES["mega_scene"] == 3
    pmk.render_tiles(mk.scene_of(cpu, W, H, "cpu"), px, py, sd, max_bounces=2)
    assert mk.BAKES["mega_scene"] == 3
    key = id(other)
    del other
    gc.collect()
    assert key not in mk._BAKED


def test_recycled_id_rebakes():
    """An entry found at a scene's id whose weak reference names another
    object (the id was recycled) is not that scene's bake: it bakes
    again, and the bake it returns is its own."""
    a = scene_to_device(_port_cs(), "cpu")
    b = scene_to_device(_port_cs(), "cpu")
    mk.BAKES["mega_scene"] = 0
    ms_a = mk.scene_of(a, W, H, "cpu")
    mk._BAKED[id(b)] = mk._BAKED[id(a)]  # b now sits at an id whose entry is a's
    ms_b = mk.scene_of(b, W, H, "cpu")
    assert mk.BAKES["mega_scene"] == 2 and ms_b is not ms_a
    assert mk._BAKED[id(b)][0]() is b
    assert mk.scene_of(b, W, H, "cpu") is ms_b and mk.BAKES["mega_scene"] == 2


# ----------------------------------------------------------------------------
# the JAX form against hijiki_tpu's same call (interpret mode)
# ----------------------------------------------------------------------------

JW = JH = 32


@pytest.fixture(scope="module")
def jax_pair():
    from hijiki_tpu_torch.scene.compile import from_reference  # noqa: F401 (port_scene's)

    s = j_load(MESHBOX_SMALL)
    s.put_cbox_spheres()
    jcs = j_compile(s)
    return j_to_device(jcs), scene_to_device(port_scene(jcs), "cpu")


def _agree(rng_a, rng_b, total_a, total_b, frac=0.995):
    same = np.asarray(rng_a).astype(np.uint32) == np.asarray(rng_b).astype(np.uint32)
    close = np.isclose(np.asarray(total_a), np.asarray(total_b), rtol=2e-3, atol=2e-3).all(-1)
    assert same.mean() >= frac, f"RNG states differ on {1 - same.mean():.3%} of paths"
    assert (same & close).mean() >= frac, f"paths disagree: {1 - (same & close).mean():.3%}"


@pytest.mark.parametrize("entry", ["render_tiles", "render_waves"])
def test_jax_form_matches_tpu_kernel(jax_pair, entry):
    from hijiki_tpu.ops import pallas_megakernel as jmk

    jcs, cs = jax_pair
    px, py, seeds = frame_inputs(JW, JH, 0.37, 0.61, 2654435761)
    kw = dict(width=JW, height=JH, max_bounces=24, packet=128)
    want = getattr(jmk, entry)(jcs, jnp.asarray(px), jnp.asarray(py), jnp.asarray(seeds),
                               interpret=True, **kw)
    got = getattr(pmk, entry)(cs, torch.from_numpy(px), torch.from_numpy(py),
                              torch.from_numpy(seeds), interpret=True, **kw)
    _agree(want[3], got[3].numpy().view(np.uint32), want[0], got[0].numpy())
    if entry == "render_waves":
        assert int(want[4]) == 0 and int(got[4]) == 0


def test_chained_jax_form_matches_tpu_kernel(jax_pair):
    from hijiki_tpu.ops import pallas_megakernel as jmk

    jcs, cs = jax_pair
    rng = np.random.default_rng(5)
    px, py, _ = frame_inputs(JW, JH, 0.0, 0.0, 1)
    offs = rng.random((3, 2), dtype=np.float32)
    pxs = np.stack([px + o[0] for o in offs])
    pys = np.stack([py + o[1] for o in offs])
    sds = np.stack([((np.arange(JW * JH) * 2654435761 + s * 977) % (1 << 32)).astype(np.uint32)
                    for s in range(3)])
    kw = dict(width=JW, height=JH, max_bounces=24, chain_cap=8)
    jc = jmk.render_waves_chained(jcs, jnp.asarray(pxs), jnp.asarray(pys), jnp.asarray(sds),
                                  interpret=True, **kw)
    tc = pmk.render_waves_chained(cs, torch.from_numpy(pxs), torch.from_numpy(pys),
                                  torch.from_numpy(sds.view(np.int32)), interpret=True, **kw)
    assert int(jc[4]) == 0 and int(tc[4]) == 0
    close = np.isclose(np.asarray(jc[0]), tc[0].numpy(), rtol=2e-3, atol=2e-3).all(-1)
    js, ts = np.asarray(jc[3]), tc[3].numpy().view(np.uint32)
    # the TPU kernel returns the RNG of the parked samples only
    agree = close & ((js == 0) | (js == ts))
    assert agree.mean() >= 0.995, f"samples disagree: {1 - agree.mean():.3%}"


# ----------------------------------------------------------------------------
# the sweep functions
# ----------------------------------------------------------------------------

SW = SH = 64
BLOCK = 64


def _sched(n, seed=3):
    sc = BlockScheduler(SW, SH, BLOCK, seed)
    return [sc.sweep(s) for s in range(n)]


@pytest.mark.parametrize("driver", ["mega", "sync"])
@pytest.mark.parametrize("from_blocks", [False, True])
def test_render_sweep_jax_form_equals_port_form(cs, driver, from_blocks):
    """JAX's keyword form (per-pixel seeds, or block seeds with
    ``seeds_from_blocks``) is the port's ``config`` form bit for bit."""
    sch = _sched(1)[0]
    cfg = rnd.RenderConfig(width=SW, height=SH, block_size=BLOCK, max_bounces=12, driver=driver)
    scene = mk.mega_scene(cs, SW, SH, "cpu") if driver == "mega" else cs
    want, wst = rnd.render_sweep(scene, sch.block_seeds, sch.sample_offset, cfg)
    seeds = sch.block_seeds if from_blocks else per_pixel_seeds(SW, SH, BLOCK, sch.block_seeds)
    got, gst = rnd.render_sweep(
        cs, torch.from_numpy(np.asarray(seeds, np.uint32).astype(np.int64)),
        torch.from_numpy(sch.sample_offset), width=SW, height=SH, block_size=BLOCK,
        use_bvh=True, max_bounces=12, radius=2, stddev=0.5, leaf_size=1, driver=driver,
        mega_packet=1024 if driver == "mega" else 128, seeds_from_blocks=from_blocks,
        interpret=True,
    )
    assert torch.equal(got, want)
    assert int(gst["wave_overflow"]) == int(wst["wave_overflow"])
    with pytest.raises(TypeError, match="needs"):
        rnd.render_sweep(cs, seeds, sch.sample_offset, width=SW, height=SH)


def test_render_sweeps_chained_jax_form_equals_port_form(cs):
    scheds = _sched(3)
    bs = np.stack([s.block_seeds for s in scheds])
    offs = np.stack([s.sample_offset for s in scheds])
    cfg = rnd.RenderConfig(width=SW, height=SH, block_size=BLOCK, max_bounces=12, driver="mega")
    want, _ = rnd.render_sweeps_chained(mk.mega_scene(cs, SW, SH, "cpu"), bs, offs, cfg)
    got, st = rnd.render_sweeps_chained(cs, bs, offs, width=SW, height=SH, block_size=BLOCK,
                                        max_bounces=12, stddev=0.5, chain_cap=8, mega_groups=4,
                                        mega_table_hbm=True, interpret=True)
    assert torch.equal(got, want) and int(st["wave_overflow"]) == 0
    with pytest.raises(TypeError):
        rnd.render_sweeps_chained(cs, bs, offs, width=SW, height=SH, block_size=BLOCK,
                                  max_bounces=12, stddev=0.5, no_such_kwarg=1)


# ----------------------------------------------------------------------------
# the resolvers against JAX's on the CPU backend
# ----------------------------------------------------------------------------

ENV = ("HIJIKI_CHAIN_SWEEPS", "HIJIKI_MEGA_PACKET", "HIJIKI_SPEC_RESOLVE", "HIJIKI_MEGA_GROUPS",
       "HIJIKI_MEGA_TRUNK", "HIJIKI_SHADOW_TBL", "HIJIKI_MEGA_WINDOW")


@pytest.fixture
def no_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert jax.devices()[0].platform == "cpu"


class _Scene:
    mega_num_tables_static = 1
    mega_tbl_rows = 5000


RESOLVERS = {
    "resolve_spec_resolve": [(r, h) for r in (-1, 0, 1) for h in (False, True)],
    "resolve_mega_groups": [(r, p, h) for r in (0, 1, 2, 4) for p in (128, 256, 384, 1024)
                            for h in (False, True)],
    "resolve_mega_trunk": [(r, h, _Scene()) for r in (-2, -1, 0, 64, 9000) for h in (False, True)],
    "resolve_mega_window": [(r, h) for r in (-1, 0, 1, 4) for h in (False, True)],
    "resolve_shadow_tbl": [(r, h, None) for r in (-1, 0, 1) for h in (False, True)],
    "resolve_mega_packet": [(r, s) for r in (0, 128) for s in (False, True)],
}


@pytest.mark.parametrize("name", list(RESOLVERS))
def test_resolver_matches_jax(no_env, name):
    from hijiki_tpu.render import renderer as jrnd

    for args in RESOLVERS[name]:
        assert getattr(rnd, name)(*args) == getattr(jrnd, name)(*args), (name, args)
    assert rnd.MEGA_TRUNK_BYTES == jrnd.MEGA_TRUNK_BYTES


def test_resolve_chain_sweeps_forms(no_env):
    """JAX's (config, table_hbm, sweeps_done) beside the port's device
    form: explicit requests and the HBM path resolve as JAX's; the auto
    default is the card's (8 sweeps a launch, ``chain_chunk_size``) where
    JAX on the CPU backend resolves 1."""
    from hijiki_tpu.render import renderer as jrnd

    for cs_ in (0, 1, 3):
        for hbm in (False, True):
            cfg = rnd.RenderConfig(driver="mega", spp=12, chain_sweeps=cs_)
            jcfg = jrnd.RenderConfig(driver="mega", spp=12, chain_sweeps=cs_)
            want = jrnd.resolve_chain_sweeps(jcfg, hbm, 4)
            got = rnd.resolve_chain_sweeps(cfg, hbm, 4)
            assert got == (want if cs_ or hbm else rnd.chain_chunk_size(8, 8)), (cs_, hbm)
    cfg = rnd.RenderConfig(driver="mega", spp=12)
    assert rnd.resolve_chain_sweeps(cfg, "cpu") == 1
    assert rnd.resolve_chain_sweeps(cfg, device="cuda", sweeps_done=6) == 6


# ----------------------------------------------------------------------------
# single names
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_reconstruct_pallas_matches_jax(weighted):
    from hijiki_tpu.render.pallas_reconstruct import reconstruct_pallas as j_rp
    from hijiki_tpu_torch.render import pallas_reconstruct as prc

    rng = np.random.default_rng(7)
    Hh, Ww, B = 40, 72, 32
    color = (rng.random((Hh, Ww, 3)) * 3.0).astype(np.float32)
    color[rng.random((Hh, Ww)) < 0.01] = np.nan
    normal = rng.standard_normal((Hh, Ww, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    so = rng.random(2).astype(np.float32)
    weight = (rng.random((Hh, Ww)) > 0.2).astype(np.float32) if weighted else None
    want = np.asarray(j_rp(jnp.asarray(color), jnp.asarray(normal), jnp.asarray(so),
                           None if weight is None else jnp.asarray(weight), block_size=B,
                           stddev=0.5, interpret=True, strip=8))
    t = torch.from_numpy
    w = None if weight is None else t(weight)
    got = prc.reconstruct_pallas(t(color), t(normal), t(so), w, block_size=B, stddev=0.5,
                                 interpret=True, strip=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, prc.reconstruct(t(color), t(normal), so, block_size=B,
                                            sample_weight=w))
    assert prc.STRIP == 8


def test_sort_tile_by_key_matches_jax():
    """The (8,128) tile form against JAX's network in interpret mode
    (tests/test_torch_sort.py's harness): key and channels bit-equal, each
    channel's dtype restored."""
    from test_torch_sort import _tpu_sort
    from hijiki_tpu_torch.ops import pallas_sort as ps

    rng = np.random.default_rng(11)
    shape = (ps.SUBLANES, ps.PACKET)
    key = rng.integers(0, 40, shape).astype(np.int32)  # many ties
    p = np.arange(1024, dtype=np.int32).reshape(shape)
    f = rng.standard_normal(shape).astype(np.float32)
    u = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    want = _tpu_sort(jnp.asarray(key), jnp.asarray(p), jnp.asarray(f), jnp.asarray(u))
    t = torch.from_numpy
    skey, (gp, gf, gu) = ps.sort_tile_by_key(t(key), [t(p), t(f), t(u)])
    assert (gp.dtype, gf.dtype, gu.dtype) == (torch.int32, torch.float32, torch.uint32)
    np.testing.assert_array_equal(skey.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(gf.numpy().view(np.uint32), np.asarray(want[2]).view(np.uint32))
    np.testing.assert_array_equal(gu.view(torch.int32).numpy().view(np.uint32),
                                  np.asarray(want[3]))
    k0, none = ps.sort_tile_by_key(t(key), [])
    assert none == [] and torch.equal(k0, skey)


@pytest.mark.parametrize("rows", [16, 21])
def test_pad_rows_table_matches_jax(rows):
    from hijiki_tpu.ops.pallas_traverse import pad_rows_table as j_pad
    from hijiki_tpu_torch.ops.pallas_traverse import pad_rows_table

    a = np.random.default_rng(rows).standard_normal((rows, 32)).astype(np.float64)
    want = np.asarray(j_pad(jnp.asarray(a, jnp.float32)))
    got = pad_rows_table(torch.from_numpy(a))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_traverse_packets_interpret(cs):
    from hijiki_tpu_torch.ops.pallas_traverse import traverse_packets
    from torch_port_helpers import random_rays

    o, d, tmin, tmax = (torch.from_numpy(x) for x in random_rays(cs, 256, 3))
    a = traverse_packets(cs.trace_rows, o, d, tmin, tmax, interpret=True)
    b = traverse_packets(cs.trace_rows, o, d, tmin, tmax)
    _equal(a, b)


@pytest.mark.parametrize("fn", ["uint_to_unit_float", "rand_uniform_float",
                                "rand_cos_hemisphere", "rand_uniform_sphere",
                                "rand_barycentric"])
def test_rng_numpy_xp_matches_jax(fn):
    """With ``xp=numpy`` the function computes in numpy and returns numpy,
    JAX's own numpy results bit for bit."""
    from hijiki_tpu.ops import rng as jrng
    from hijiki_tpu_torch.ops import rng as trng

    state = np.random.default_rng(1).integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    state[:3] = (0, 1, 0xFFFFFFFF)

    def leaves(x):
        return [x] if isinstance(x, np.ndarray) else [y for e in x for y in leaves(e)]

    want = leaves(getattr(jrng, fn)(state, np))
    got = leaves(getattr(trng, fn)(state, np))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def test_scene_to_device_names_its_device():
    host = _port_cs()
    a, b = scene_to_device(host, "cpu"), to_device(host, "cpu")
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), f.name
    assert inspect.signature(scene_to_device).parameters["device"].default is None


# ----------------------------------------------------------------------------
# the multi-device functions
# ----------------------------------------------------------------------------

MW, MH, MB = 32, 128, 64


@pytest.fixture(scope="module")
def host_cs():
    return _port_cs()


@pytest.mark.parametrize("n_sweeps", [1, 2])
def test_sharded_mega_sweep_equals_renderer_chunk(host_cs, n_sweeps):
    """``make_sharded_mega_sweep(["cpu", "cpu"], ...)`` with block seeds
    gives the two-band renderer's chunk, bit for bit, assembled."""
    from hijiki_tpu_torch.parallel.multichip import MegaMultiChipRenderer, make_sharded_mega_sweep

    kw = dict(width=MW, height=MH, block_size=MB, max_bounces=12, stddev=0.5)
    fn = make_sharded_mega_sweep(["cpu", "cpu"], host_cs, n_sweeps=n_sweeps,
                                 seeds_from_blocks=True, chain_cap=4, packet=1024, groups=4,
                                 interpret=True, **kw)
    cfg = rnd.RenderConfig(width=MW, height=MH, block_size=MB, max_bounces=12, driver="mega",
                           mega_chain_cap=4)
    r = MegaMultiChipRenderer(host_cs, cfg, devices=["cpu", "cpu"])
    sc = BlockScheduler(MW, MH, MB, 9)
    scheds = [sc.sweep(s) for s in range(n_sweeps)]
    bs = np.stack([s.block_seeds for s in scheds])
    offs = np.stack([s.sample_offset for s in scheds])
    delta, ovf = fn(host_cs, bs, offs)
    kind = "chained" if n_sweeps > 1 else "sweep"
    bands, stats = r._run_chunk(kind, bs if n_sweeps > 1 else bs[0],
                                offs if n_sweeps > 1 else offs[0], ())
    assert delta.shape == (MH, MW, 4)
    assert torch.equal(delta, torch.cat(bands))
    assert int(ovf) == int(stats["wave_overflow"]) == 0
    with pytest.raises(ValueError, match="another scene"):
        fn(dataclasses.replace(host_cs), bs, offs)


def test_sharded_mega_sweep_pixel_form(host_cs):
    """Without ``seeds_from_blocks`` the function takes the frame's px, py
    and per-pixel seeds, as JAX's: the same delta as the block form."""
    from hijiki_tpu_torch.parallel.multichip import make_sharded_mega_sweep

    kw = dict(width=MW, height=MH, block_size=MB, max_bounces=12, stddev=0.5)
    sch = BlockScheduler(MW, MH, MB, 9).sweep(0)
    blocks = make_sharded_mega_sweep(["cpu", "cpu"], host_cs, seeds_from_blocks=True, **kw)
    pixels = make_sharded_mega_sweep(["cpu", "cpu"], host_cs, **kw)
    want, _ = blocks(host_cs, sch.block_seeds[None], sch.sample_offset[None])
    y, x = np.mgrid[0:MH, 0:MW]
    px = (x + sch.sample_offset[0]).ravel().astype(np.float32)
    py = (y + sch.sample_offset[1]).ravel().astype(np.float32)
    seeds = per_pixel_seeds(MW, MH, MB, sch.block_seeds).ravel()
    got, ovf = pixels(host_cs, px, py, seeds, sch.sample_offset)
    assert torch.equal(got, want) and int(ovf) == 0


def test_sharded_sweep_equals_renderer_chunk(host_cs):
    """``make_sharded_sweep`` (the sync driver's block shares) gives
    ``MultiChipRenderer``'s sweep, and ``trace_blocks``' keyword form its
    config form's delta."""
    from hijiki_tpu_torch.parallel.multichip import (
        MultiChipRenderer, make_sharded_sweep, trace_blocks,
    )

    kw = dict(width=2 * MB, height=MB, block_size=MB, use_bvh=True, max_bounces=6, radius=2,
              stddev=0.5, leaf_size=1)
    fn = make_sharded_sweep(["cpu", "cpu"], host_cs, **kw)
    cfg = rnd.RenderConfig(width=2 * MB, height=MB, block_size=MB, max_bounces=6,
                           driver="sync")
    r = MultiChipRenderer(host_cs, cfg, devices=["cpu", "cpu"])
    sch = BlockScheduler(2 * MB, MB, MB, 4).sweep(0)
    seeds = np.concatenate([sch.block_seeds.reshape(-1),
                            np.zeros(len(r.block_origins) - sch.block_seeds.size, np.uint32)])
    want, _ = r._run_chunk("sweep", sch.block_seeds, sch.sample_offset, ())
    got = fn(host_cs, r.block_origins, r.block_dims, seeds, sch.sample_offset)
    assert torch.equal(got, want)
    k = len(r.block_origins) // 2
    one = trace_blocks(r.scenes[0], r.block_origins[:k], r.block_dims[:k], seeds[:k],
                       sch.sample_offset, **kw)
    cfg_form, _ = trace_blocks(r.scenes[0], r.block_origins[:k], r.block_dims[:k], seeds[:k],
                               sch.sample_offset, cfg)
    assert torch.equal(one, cfg_form)


def test_settle_mega_overflow(host_cs):
    """The module function settles a list of sweeps: no drop, no retry;
    a drop re-renders every schedule at full capacity from ``film_start``,
    and the film is the full-capacity render bit for bit."""
    from hijiki_tpu_torch.parallel.multichip import MegaMultiChipRenderer, settle_mega_overflow

    cfg = rnd.RenderConfig(width=MW, height=MH, block_size=MB, max_bounces=12, driver="mega",
                           spp=2)
    r = MegaMultiChipRenderer(host_cs, cfg, devices=["cpu", "cpu"], interpret=True)
    scheds = [r.scheduler.sweep(s) for s in range(2)]
    start = r.film
    zero = torch.zeros((), dtype=torch.int64)
    assert settle_mega_overflow(r, scheds, [zero, zero], start) == 0
    assert torch.equal(r.film, start)
    with pytest.warns(UserWarning, match="full capacity"):
        assert settle_mega_overflow(r, scheds, [zero, zero + 3], start) == 3
    want = start
    for s in scheds:
        bands, _ = r._run_chunk("sweep", s.block_seeds, s.sample_offset, (1,) * 8)
        want = want + torch.cat(bands)
    assert torch.equal(r.film, want)
