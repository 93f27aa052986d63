"""The port's loss head at the shapes this slice adds, against the JAX
package's XLA loss (tests/test_torch_train_epilogue.py's reference and
check, whose tolerances hold: bf16 loss within 2e-5 and gradients within
2e-2 of each leaf's max, f32 1e-6 / 1e-5): more than 256 classes (Q =
512, which the kernel walks in two 256-column chunks; Q = 264, a partial
second chunk), and one frame a sample (FR = 1, the upsampled condition).
On the CPU the plain twin runs; the kernel is held to it on the card
(chip_smoke.py [train-epilogue])."""
import pytest

from test_torch_train_epilogue import test_epilogue_matches_xla as check

# (S, Q, B, T, C, FR)
CASES = {"q512": (64, 512, 2, 256, 16, 64),
         "q264": (32, 264, 1, 128, 16, 32),
         "fr1": (64, 256, 2, 192, 16, 1),
         "q512-fr1": (32, 512, 1, 128, 8, 1)}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype,loss_tol,grad_tol", [
    ("bf16", 2e-5, 2e-2), ("f32", 1e-6, 1e-5)])
def test_loss_head_matches_jax(name, dtype, loss_tol, grad_tol):
    check(dtype, loss_tol, grad_tol, CASES[name])
