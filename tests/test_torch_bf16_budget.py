"""The bf16 token-agreement budget: the port's ServeEngine (on the CPU)
against the reference's, both in bf16 on the same weights (the reference's
bf16 parameters carried over bit for bit by the bridge), under the LERC
store with byte pressure, on ``test_torch_engine.py``'s workload: the paged
plane on the qwen2-7b smoke config and the gather plane on gemma2-27b smoke
(rolling-window L layers, softcaps).

In f32 the two engines give identical tokens (``test_torch_engine.py``).
In bf16 the packages round at other places (fused XLA ops against eager
PyTorch ops), and near-tied logits of a random smoke model flip, so this
test holds the fraction of generated tokens that agree, position by
position, to a floor below the measured fraction of each config. The
store's decisions depend on the prompts alone, so the eviction log,
prefix reuse and step count stay identical."""
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import model_spec as jax_model_spec  # noqa: E402
from repro.serve import PrefixStore as JaxStore  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import params_from_numpy, tree_paths  # noqa: E402
from repro_torch.serve import PrefixStore, ServeEngine  # noqa: E402
# the f32 parity tests' workload and engine runner
from test_torch_engine import MAX_NEW, _run  # noqa: E402

# arch -> (paged, prefill chunk, measured agreement, floor). Measured on
# the CPU: 32 of 40 tokens (qwen2) and 29 of 40 (gemma2); each floor sits
# four tokens of 40 below its measurement.
BUDGET = {
    "qwen2_7b": (True, 8, 32 / 40, 28 / 40),
    "gemma2_27b": (False, 1, 29 / 40, 25 / 40),
}


@pytest.mark.parametrize("arch", sorted(BUDGET))
def test_bf16_tokens_agree_within_budget(arch):
    paged, chunk, measured, floor = BUDGET[arch]
    jcfg = jax_configs.get(arch, smoke=True)
    tcfg = configs.get(arch, smoke=True)
    assert jcfg.dtype == jnp.bfloat16 and tcfg.dtype == torch.bfloat16
    jparams = jax_init_params(jax.random.key(0), jax_model_spec(jcfg),
                              dtype=jnp.bfloat16)
    tparams = params_from_numpy(jax.device_get(jparams))
    assert {t.dtype for _, t in tree_paths(tparams)} == {torch.bfloat16}
    jeng, jst, jrs = _run(JaxEngine, JaxStore, jcfg, jparams, "lerc", chunk,
                          None, paged=paged)
    teng, tst, trs = _run(ServeEngine, PrefixStore, tcfg, tparams, "lerc",
                          chunk, None, paged=paged, device="cpu")
    assert teng.paged == jeng.paged == paged
    assert jst.evictions > 0, "workload produced no pressure"
    assert tst.eviction_log == jst.eviction_log
    assert [r.prefill_skipped for r in trs] == \
        [r.prefill_skipped for r in jrs]
    assert teng.steps == jeng.steps
    want = [x for r in jrs for x in r.generated]
    got = [x for r in trs for x in r.generated]
    assert len(got) == len(want) == MAX_NEW * len(jrs)
    agree = sum(x == y for x, y in zip(got, want)) / len(want)
    assert agree >= floor, (arch, agree, measured)
