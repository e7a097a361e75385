"""Gluon (aligned) Xception-65 and -71 against the JAX package on the CPU:
the entry, middle and exit blocks, Xception-71's stride-1 entry block with
its projection, and the whole Xception-71 (its deep entry flow), in eval
and train mode (``test_torch_zoo3.py``'s cases and checks, run here so that
``--dist loadfile`` spreads the compiles over the workers)."""

import pytest
import torch

from scouter_tpu.models import gluon_xception as jax_gluon
from scouter_tpu_torch.models import gluon_xception as gluon
from test_torch_zoo3 import Case, check_eval, check_train, net, run_case
from test_torch_zoo3_families import same


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
    "gluon_entry": Case(*same(jax_gluon._Block, gluon._Block, 64, 128, 2, 2,
                              start_with_relu=False), (2, 9, 9, 64)),
    # Xception-71's first entry block: stride 1 with a projection
    "gluon_entry_stride1": Case(*same(jax_gluon._Block, gluon._Block, 128, 256, 2, 1,
                                      start_with_relu=False), (2, 5, 5, 128)),
    "gluon_middle": Case(*same(jax_gluon._Block, gluon._Block, 728, 728, 3, 1),
                         (2, 5, 5, 728)),
    "gluon_exit": Case(*same(jax_gluon._Block, gluon._Block, 728, 1024, 2, 2, grow_first=False,
                             is_last=True), (2, 5, 5, 728)),
    # Xception-71 (the deep entry flow, block3 after a 728-wide Sequential);
    # 96 px: at 32 and 64 the last maps are 1 x 1 and the train-mode f32
    # forward lies 1.3 and 0.37 from float64 (at 96 px, 4e-5; 1.5e-3 at batch 1)
    "gluon_xception71": net(jax_gluon.Xception65, gluon.Xception65, 96, deep_entry=True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case_run(request):
    return run_case(CASES[request.param])


def test_eval_features_and_logits(case_run):
    check_eval(case_run)


def test_train_outputs_and_running_stats(case_run):
    check_train(case_run)
