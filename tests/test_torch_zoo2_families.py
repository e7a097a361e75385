"""The second backbone slice's other families against the JAX package on
the CPU: RegNet X and Y, DLA (plain, X with a residual root, Res2Net),
VoVNet (eSE with residuals, ECA on depthwise blocks, EvoNorm, InplaceABN),
DenseNet (plain, blur with the deep stem, InplaceABN with the tiered stem),
HRNet's fuse layers and SENet's 3-conv stem, each in eval and train mode
(``test_torch_zoo2.py``'s cases and checks, run here so that ``--dist
loadfile`` spreads the compiles over the workers)."""

import pytest
import torch

from test_torch_zoo2 import FAMILY_MECHANISMS, check_eval, check_train, mechanism_case


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


@pytest.fixture(scope="module", params=FAMILY_MECHANISMS)
def family_mechanism(request):
    return mechanism_case(request.param)


def test_family_mechanism_eval_features_and_logits(family_mechanism):
    check_eval(family_mechanism)


def test_family_mechanism_train_logits_and_running_stats(family_mechanism):
    check_train(family_mechanism)
