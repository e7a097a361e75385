"""NASNet-A Large against the JAX package on the CPU: each cell kind at
narrow widths (the stem cells, the first, normal and both reduction cells,
the first with the shifted zero-pad pools and branches) and a narrow NASNet
(``num_features`` 192) whole, in eval and train mode
(``test_torch_zoo3.py``'s cases and checks, run here so that ``--dist
loadfile`` spreads the compiles over the workers)."""

import pytest
import torch

from scouter_tpu.models import nasnet as jax_nasnet
from scouter_tpu_torch.models import nasnet
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
    "nasnet_cell_stem_0": Case(lambda: jax_nasnet._CellStem0(4),
                               lambda: nasnet._CellStem0(12, 4), (2, 11, 11, 12)),
    # the factorized reduction of an odd map (11 -> 6)
    "nasnet_cell_stem_1": Case(lambda: jax_nasnet._CellStem1(8),
                               lambda: nasnet._CellStem1(12, 16, 8),
                               (2, 11, 11, 12), (2, 6, 6, 16)),
    "nasnet_first_cell": Case(lambda: jax_nasnet._FirstCell(4, 8),
                              lambda: nasnet._NormalCell(24, 16, 4, 8, first=True),
                              (2, 5, 5, 24), (2, 10, 10, 16)),
    "nasnet_normal_cell": Case(lambda: jax_nasnet._NormalCell(8, 8),
                               lambda: nasnet._NormalCell(48, 24, 8, 8),
                               (2, 5, 5, 48), (2, 5, 5, 24)),
    "nasnet_reduction_cell_pad": Case(lambda: jax_nasnet._ReductionCell(8, 8, True),
                                      lambda: nasnet._ReductionCell(48, 48, 8, 8, True),
                                      (2, 7, 7, 48), (2, 7, 7, 48)),
    "nasnet_reduction_cell": Case(lambda: jax_nasnet._ReductionCell(8, 8, False),
                                  lambda: nasnet._ReductionCell(48, 48, 8, 8, False),
                                  (2, 7, 7, 48), (2, 7, 7, 48)),
    # ch = 8: the stem cells 2 and 4 wide, the stages 8, 16 and 32; 96 px, one
    # image: the last maps 3 x 3, the train-mode f32 forward 2e-5 from float64
    "nasnet_narrow": net(jax_nasnet.NASNetALarge, nasnet.NASNetALarge, 96, batch=1,
                         num_features=192),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case_run(request):
    return run_case(CASES[request.param])


def test_eval_features_and_logits(case_run):
    check_eval(case_run)


def test_train_outputs_and_running_stats(case_run):
    check_train(case_run)
