"""The JAX package's ``ops/pallas_megakernel.py`` names, on the port.

``from hijiki_tpu.ops.pallas_megakernel import render_waves`` becomes
``from hijiki_tpu_torch.ops.pallas_megakernel import render_waves``: the
render entries take JAX's call form (a ``CompiledScene`` with ``width`` and
``height``, the TPU walker's kwargs) beside the port's ``MegaScene`` form,
and run K1/K2/K4/K5 of ``csrc/megakernel.cu`` on a CUDA tensor, their plain
twins on a CPU one (``ops/megakernel.py``). The trace-row format constants
are the compiler's (``scene/compile.py``).

Not carried over, because they describe the TPU's layout or its Mosaic
kernel and nothing the port computes: ``MEGA_PACKET_TPU``,
``MEGA_GROUPS_TPU``, ``CHAIN_SWEEPS_TPU`` (the card's is
``CHAIN_SWEEPS_CUDA``), ``HBM_ROW_WIDTH``, ``base_cfg_nochain`` and the
``f32`` alias of a jnp dtype.
"""

from hijiki_tpu_torch.ops.megakernel import (  # noqa: F401
    BIG,
    CHAIN_OUT_CH,
    KIND_QUAD,
    KIND_SPHERE,
    KIND_TRIANGLE,
    M_EPS,
    M_PI,
    N_STATE,
    PACKET,
    SUBLANES,
    TAG_DIELECTRIC,
    TAG_DIFFUSE,
    TAG_DIFFUSECBOARD,
    TAG_EMISSIVE,
    TAG_MIRROR,
    TILE,
    render_tiles,
    render_waves,
    render_waves_chained,
)
from hijiki_tpu_torch.scene.compile import (  # noqa: F401
    PACKED3_BASES,
    PACKED3_N,
    PACKED3_SLOT_COL,
    PACKED12_BASES,
    PACKED12_N,
    PACKED12_SLOT_COL,
    PACKED_BASE,
    PACKED_N,
    PACKED_STRIDE,
    SLIM_PAY_STRIDE,
    SLIM_SLOT_COL,
    TRACE_ROW_WIDTH as TRACE_COLS,
)
