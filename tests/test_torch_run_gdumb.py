"""GDumb's golden pin (see test_torch_run.py), in a file of its own: it
takes about three minutes on one thread, and under pytest-xdist's
--dist loadfile a file of its own runs beside test_torch_run.py, not after
it.

GDumb retrains each task's model from scratch, so its runs spread widely:
over seeds 1-2 alone the port parts from the golden by 0.104 (the golden's
seed 2 reads 0.78 against 0.50-0.60 on the others), over seeds 1-5 by
0.002 (`python tests/test_torch_run.py seeds GDUMB`). The pin takes the
five seeds at the 5-seed band.
"""

from test_torch_run import GDUMB_PIN, golden_gap, torch_threads


def test_golden_parity_gdumb():
    name, seeds, band = GDUMB_PIN
    with torch_threads(1):
        ref_acc, port_acc = golden_gap(name, seeds)
    assert abs(ref_acc - port_acc) < band, (ref_acc, port_acc)
