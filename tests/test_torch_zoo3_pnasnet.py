"""PNASNet-5 Large against the JAX package on the CPU: each cell kind at
narrow widths (the stem cell, the factorized-reduction cell, the reduction
cells with and without the shifted zero pad, the normal cell, on odd maps
where the network has them) and the whole network at 96 px, in eval and
train mode (``test_torch_zoo3.py``'s cases and checks, run here so that
``--dist loadfile`` spreads the compiles over the workers)."""

import pytest
import torch

from scouter_tpu.models import pnasnet as jax_pnasnet
from scouter_tpu_torch.models import pnasnet
from test_torch_zoo3 import Case, check_eval, check_train, net, run_case


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _full_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


CASES = {
    "pnasnet_cell_stem_0": Case(lambda: jax_pnasnet._CellStem0(8, 8),
                                lambda: pnasnet._CellStem0(12, 8, 8), (2, 9, 9, 12)),
    "pnasnet_cell_match_prev": Case(lambda: jax_pnasnet._PCell(8, 8, match_prev=True),
                                    lambda: pnasnet._PCell(12, 40, 8, 8, match_prev=True),
                                    (2, 9, 9, 12), (2, 5, 5, 40)),
    # on an even map, as in the network (an odd one misaligns its branches in
    # JAX too)
    "pnasnet_cell_reduction_zero_pad": Case(
        lambda: jax_pnasnet._PCell(8, 8, is_reduction=True, zero_pad=True),
        lambda: pnasnet._PCell(40, 40, 8, 8, is_reduction=True, zero_pad=True),
        (2, 8, 8, 40), (2, 8, 8, 40)),
    "pnasnet_cell_reduction": Case(lambda: jax_pnasnet._PCell(8, 8, is_reduction=True),
                                   lambda: pnasnet._PCell(40, 40, 8, 8, is_reduction=True),
                                   (2, 7, 7, 40), (2, 7, 7, 40)),
    "pnasnet_cell_normal": Case(lambda: jax_pnasnet._PCell(8, 8),
                                lambda: pnasnet._PCell(40, 40, 8, 8),
                                (2, 5, 5, 40), (2, 5, 5, 40)),
    # one image at 96 px (the last maps 3 x 3, the train-mode f32 forward 3e-5
    # from float64), the head dropout off: train mode would draw a mask at
    # its default 0.5
    "pnasnet5large": net(jax_pnasnet.PNASNet5Large, pnasnet.PNASNet5Large, 96, batch=1,
                         drop_rate=0.0),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case_run(request):
    return run_case(CASES[request.param])


def test_eval_features_and_logits(case_run):
    check_eval(case_run)


def test_train_outputs_and_running_stats(case_run):
    check_train(case_run)


def test_pnasnet_head_dropout_defaults_to_half():
    """timm's PNASNet drops half the pooled features in training
    (pnasnet.py:287); the port's default is the JAX package's."""
    assert pnasnet.PNASNet5Large(num_classes=0).drop_rate == 0.5
    assert jax_pnasnet.PNASNet5Large().drop_rate == 0.5
