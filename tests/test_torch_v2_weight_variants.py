"""The port's per-weight v2 kernel variants v3, v2f, v2h and v2s against
the JAX package's Pallas bodies in interpret mode (the layers and the
checks of test_torch_v2_variants.py; a file of their own so that neither
file holds up one test worker for long). The kernels themselves are
checked on the card by tests/test_torch_kernel_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gptq_gguf_tpu.ops import qmatmul as jq
from gptq_gguf_tpu_torch.ops import qmatmul
from tests.test_torch_qmatmul import ALL_K
from tests.test_torch_v2_variants import MXU, PLAIN, _pair, check_plain_against_jax


@pytest.mark.parametrize("mxu", list(MXU))
@pytest.mark.parametrize("M", [1, 8, 33])
@pytest.mark.parametrize("variant,qtype", [(v, q) for v in ("v3", "v2f", "v2h", "v2s")
                                           for q in PLAIN[v][1]],
                         ids=lambda a: getattr(a, "name", a))
def test_per_weight_plain_matches_jax_interpret(variant, qtype, M, mxu):
    """As test_plain_matches_jax_interpret: rtol 1e-5, atol 1e-4 of max|y|
    (the same products, another order of the f32 sums)."""
    check_plain_against_jax(variant, qtype, M, mxu)


@pytest.mark.parametrize("qtype", PLAIN["v2s"][1], ids=lambda q: q.name)
def test_v2s_plain_matches_jax_interpret_at_prefill_rows(qtype):
    """v2s at 130 rows with bf16 operands, a shape its tensor-core tiles
    serve on the card: the plain version they are held to there against
    JAX's body (rtol 1e-5, atol 1e-4 of max|y|)."""
    check_plain_against_jax("v2s", qtype, 130, "bf16")


@pytest.mark.parametrize("mxu", list(MXU))
@pytest.mark.parametrize("variant", ["v3", "v2f", "v2h"])
def test_per_weight_build_bit_equal_to_jax(variant, mxu):
    """x = I through JAX's body in interpret mode returns its weights (the
    products with 1 and 0 are exact), less the xsum term's off2 for v3: the
    plain version's weights, with each rounding in JAX's order (v2h rounds
    after its product and after its subtraction), equal them bit for bit.
    v2f's f32 weight is v2's, dequantize_runtime_v2."""
    tdt, jdt = MXU[mxu]
    eye = np.eye(512, dtype=np.float32)
    for qtype in ALL_K:
        jr, tr = _pair(qtype)
        want = np.asarray(jq.dequant_matmul_pallas_v2(jnp.asarray(eye), jr, interpret=True,
                                                      variant=variant, mxu_dtype=jdt))
        got = PLAIN[variant][0](torch.from_numpy(eye), tr, tdt).numpy()
        np.testing.assert_array_equal(got, want, err_msg=qtype.name)
        if variant == "v2f":
            w, corrects = qmatmul._v2_operand(tr, "v2f", torch.float32)
            assert not corrects
            np.testing.assert_array_equal(w.numpy(), qmatmul.dequantize_runtime_v2(tr).T.numpy())
