"""The port's train step against the reference's on the smoke configs of
the audio, hybrid and ssm families (musicgen-medium, recurrentgemma-2b past
its local window, rwkv6-7b), float32 on the CPU, where attention's
backward is ``flash_attention_bwd_plain`` and WKV's
``wkv_chunked_bwd_plain``.  The rules and tolerances are in
``tests/_torch_train_parity.py``; ``tests/test_torch_train_transformers.py``
holds the dense, moe and vlm families."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests import _torch_train_parity as tp  # noqa: E402

ARCHS = ("musicgen-medium", "recurrentgemma-2b", "rwkv6-7b")
MOE = ()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """Loss, aux loss, grad norm, every leaf's gradient and the updated
    parameters and AdamW moments."""
    params, state, metrics = tp.port_step(arch)
    rparams, rstate, rmetrics = tp.reference_step(arch)
    tp.check_metrics(metrics, rmetrics)
    tp.check_grads(tp.port_grads(arch), tp.reference_grads(arch))
    tp.check_params(params, rparams, rstate["m"])
    assert int(state["step"]) == int(rstate["step"]) == 1


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in MOE])
def test_grad_accum_equals_one_batch(arch):
    """accum = 2 over the same 4 sequences gives accum = 1's step: the
    loss within the reference's test_grad_accum_equivalent_to_large_batch
    tolerance (rtol 1e-4), the parameters under the first-step rule of
    ``tests/_torch_train_parity.py`` (the two sum the gradient in another
    order, so an entry within its noise may flip AdamW's sign: 2 lr there,
    where a flat 5e-4 would not hold).  The moe family is not held to it:
    its load-balancing loss is E sum_e mean_prob_e frac_e over the call's
    tokens, a product of means that a mean over microbatches does not
    equal, in the reference as in the port, and its gradient reaches every
    leaf before the router; its accum = 2 step is held to the reference's
    by test_grad_accum_matches_reference."""
    p1, s1, m1 = tp.port_step(arch)
    p2, _, m2 = tp.port_step(arch, accum=2)
    np.testing.assert_allclose(m2["loss"], m1["loss"], rtol=1e-4)
    tp.check_params(p2, tp.tree_lib.map_tree(lambda x: x.numpy(), p1),
                    tp.tree_lib.map_tree(lambda x: x.numpy(), s1["m"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accum_matches_reference(arch):
    """accum = 2 against the reference's accum = 2 step."""
    params, _, metrics = tp.port_step(arch, accum=2)
    rparams, rstate, rmetrics = tp.reference_step(arch, accum=2)
    tp.check_metrics(metrics, rmetrics)
    tp.check_params(params, rparams, rstate["m"])


@pytest.mark.parametrize("arch", ARCHS)
def test_pod_compress_matches_reference(arch):
    """int8 error-feedback compression over 2 pods (per-pod gradients of the
    microbatch's two halves): metrics, parameters and the bf16 error
    buffer against the reference's step with pod_compress, npod = 2, the
    parameters under the first-step rule with one int8 step as the
    gradient's noise (``POD_NOISE_REL``)."""
    params, state, metrics = tp.port_step(arch, pod_compress=True, npod=2)
    rparams, rstate, rmetrics = tp.reference_step(arch, pod_compress=True,
                                                  npod=2)
    tp.check_metrics(metrics, rmetrics)
    tp.check_params(params, rparams, rstate["m"], tp.POD_NOISE_REL)
    tp.check_ef_error(state["ef_error"], rstate["ef_error"])
