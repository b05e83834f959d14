"""CN-DPM at run level, on the CPU (see test_torch_run.py).

* The golden pin: seeds 1-3 of the CI parity streams at the CI sleep budget
  (100 VAE / 50 classifier steps, `G.OCL_EXTRA["CNDPM"]`) and the published
  16 z samples, |dAvg_End_Acc| < 0.07 against the committed torch-oracle
  matrices, the seeds, band and budget of ocl_tpu's own pin
  (tests/test_reference_parity.py:136-144). On one thread, as every pin.
  It takes about 14 minutes there (each sleep's 100 VAE steps decode 800
  images a step), so it is marked `slow`, which tier-1 deselects; run it
  with `pytest tests/test_torch_run_cndpm.py -m slow`.
* The mechanics, end to end through `multiple_run`: two tasks with
  max_experts 2, stm_capacity 30, a 5 / 5-step sleep and 2 z samples (the
  counterpart of tests/test_cndpm.py:66-91): the STM fills, a sleep births
  an expert, the mixture is evaluated.
* The CLI with CN-DPM's defaults but an STM that never fills (the default
  4,000 / 1,000-step sleep takes minutes on the CPU): every wake step routes
  to the STM and evaluation reports zeros.
"""

import numpy as np
import pytest

import ocl_tpu_torch.models.ndpm_vars as V
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.experiment.run import multiple_run
from test_torch_run import golden_gap, run_cli, torch_threads

CNDPM_PIN = ("CNDPM", (1, 2, 3), 0.07)


@pytest.mark.slow
def test_golden_parity_cndpm():
    name, seeds, band = CNDPM_PIN
    with torch_threads(1):
        ref_acc, port_acc = golden_gap(name, seeds)
    assert abs(ref_acc - port_acc) < band, (ref_acc, port_acc)


@pytest.fixture
def small_z_samples():
    orig = V.VAE_Z_SAMPLES
    V.VAE_Z_SAMPLES = 2
    yield
    V.VAE_Z_SAMPLES = orig


def test_cndpm_end_to_end(small_z_samples, capsys):
    params = default_params(data="synthetic", agent="CNDPM", max_experts=2, stm_capacity=30,
                            batch=10, test_batch=20, optimizer="Adam", learning_rate=0.001,
                            classifier_chill=0.01, log_alpha=-300, num_tasks=2,
                            synthetic_size=20, num_runs=1, verbose=True, device="cpu")
    params.sleep_step_g = params.sleep_step_d = 5
    with torch_threads(1):
        (avg_end_acc, _), *_ = multiple_run(params)
    out = capsys.readouterr().out
    # 40 images a task: the first 30 streamed fill the STM, a sleep follows
    experts = [int(line.split("experts: ")[1].split()[0]) for line in out.splitlines()
               if line.startswith("[CNDPM] experts:")]
    assert len(experts) == 2 and experts[0] == 1 and experts[-1] >= 1, out[-2000:]
    assert np.isfinite(avg_end_acc) and 0.0 <= avg_end_acc <= 1.0


def test_cli_runs_cndpm_without_sleep():
    run_cli("--agent", "CNDPM", "--stm_capacity", "1000")
