"""``correct`` comes out false when the timed path is broken underneath: a
run on the CPU twins at a tiny size, the harness's look for a card
skipped, with each fault that a one-chip render cell can have planted in
the renderer (a multi-chip exchange does not exist on one chip). A clean
run of the same size is correct."""

import pytest

from bench_common import SEED, TINY

import harness  # noqa: E402
from hijiki_tpu_torch.render.renderer import Renderer  # noqa: E402


class Unchanged(Renderer):
    """A render that returns its state unchanged: the film stays empty."""

    def render(self, progress=None):
        self.metrics = {}
        return self.metrics


class HalfTheSweeps(Renderer):
    """Half of the job's sweeps left out; the image is the mean of the rest."""

    def _todo(self):
        return super()._todo()[: max(1, self.config.spp // 2)]


class AlteredImage(Renderer):
    """The answer altered where it is produced: the image's red 1% high."""

    def image(self):
        img = super().image()
        img[..., 0] *= 1.01
        return img


@pytest.mark.parametrize("workload", [w["name"] for w in harness.Cell(
    "cbox-spheres.cli-default").spec["workloads"]])
@pytest.mark.parametrize("renderer, correct", [(None, True), (Unchanged, False),
                                               (HalfTheSweeps, False), (AlteredImage, False)])
def test_correct_catches_each_fault(workload, renderer, correct):
    res = harness.run(workload, SEED, 0.2, False, device="cpu", traffic=TINY,
                      renderer_class=renderer)
    assert res["correct"] is correct, res["checks"]
