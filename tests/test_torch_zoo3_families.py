"""The last backbone slice's residual-inception and Xception families
against the JAX package on the CPU: Inception-ResNet-V2's blocks (the
three residual scales and the last Block8 without its ReLU) and Xception's
(entry, middle and exit), each network whole, in eval and train mode
(``test_torch_zoo3.py``'s cases and checks, run here so that ``--dist
loadfile`` spreads the compiles over the workers)."""

import pytest
import torch

from scouter_tpu.models import inception_resnet_v2 as jax_irv2
from scouter_tpu.models import xception as jax_xception
from scouter_tpu_torch.models import inception_resnet_v2 as irv2
from scouter_tpu_torch.models import xception
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


def same(jax_cls, port_cls, *args, **kw):
    """A block both packages build from the same arguments."""
    return lambda: jax_cls(*args, **kw), lambda: port_cls(*args, **kw)


CASES = {
    "irv2_mixed_5b": Case(jax_irv2._Mixed5b, irv2._Mixed5b, (2, 9, 9, 192)),
    "irv2_block35": Case(*same(jax_irv2._Block35, irv2._Block35, 0.17), (2, 5, 5, 320)),
    "irv2_mixed_6a": Case(jax_irv2._Mixed6a, irv2._Mixed6a, (2, 9, 9, 320)),
    "irv2_block17": Case(*same(jax_irv2._Block17, irv2._Block17, 0.10), (2, 5, 5, 1088)),
    "irv2_mixed_7a": Case(jax_irv2._Mixed7a, irv2._Mixed7a, (2, 9, 9, 1088)),
    "irv2_block8": Case(*same(jax_irv2._Block8, irv2._Block8, 0.20), (2, 3, 3, 2080)),
    "irv2_block8_last": Case(*same(jax_irv2._Block8, irv2._Block8, 1.0, no_relu=True),
                             (2, 3, 3, 2080)),
    # 107 px, one image: at 75 the last maps are 1 x 1 and the train-mode
    # forward in f32 lies 0.58 from float64; at 107, 9e-6
    "inception_resnet_v2": net(jax_irv2.InceptionResnetV2, irv2.InceptionResnetV2, 107,
                               batch=1),
    # the entry block without its first ReLU, the 3x3/2 pool on an odd map
    "xception_entry": Case(*same(jax_xception._Block, xception._Block, 64, 128, 2, 2,
                                 start_with_relu=False), (2, 9, 9, 64)),
    "xception_middle": Case(*same(jax_xception._Block, xception._Block, 728, 728, 3, 1),
                            (2, 5, 5, 728)),
    "xception_exit": Case(*same(jax_xception._Block, xception._Block, 728, 1024, 2, 2,
                                grow_first=False), (2, 5, 5, 728)),
    "xception": net(jax_xception.Xception, xception.Xception, 75, batch=1),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case_run(request):
    return run_case(CASES[request.param])


def test_eval_features_and_logits(case_run):
    check_eval(case_run)


def test_train_outputs_and_running_stats(case_run):
    check_train(case_run)
