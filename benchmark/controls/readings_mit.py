"""Readings that the limits of a SegFormer training cell are set from, in
one process: ``readings.py`` for the ``train_mit`` driver.

    python3 benchmark/controls/readings_mit.py --workload <cell> --seconds <s>
        --seeds <n> ... [--control-seeds <n> ...] [--fault-seeds <n> ...]

The options are ``readings.py``'s.  For each ``--seeds`` seed, the cell's
set-up, a window of ``--seconds`` and its check, as a run does (the lower
readings).  For each ``--control-seeds`` seed, the float32 reference with
float8 e4m3 operands in every convolution and every matmul (the Linears and
the attention's two products) in the program's place; for each
``--fault-seeds`` seed, the faults planted in the reference: the state
unchanged (``unchanged``), the EMA alone unchanged (``ema``) and half of
each batch left out (``half``) (the upper readings).  One JSON line a
reading on standard output, with the verdict that ``limits/<cell>.json``
gives it; each control and fault has to come out not correct.  Needs the
card; not run by the benchmark's own runs.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.harness import core  # noqa: E402

READINGS = core.load_module(os.path.join(ROOT, "benchmark", "controls", "readings.py"),
                            "bench_readings")


def planted_numbers(ctx, driver, seed: int, **planted) -> dict:
    """{fault: numbers} of the reference with each ``planted`` (``control``,
    ``fault`` or ``rows``: a name -> its keyword arguments) in the program's
    place, against the reference, which runs once."""
    checked = READINGS.train_batches(ctx, seed)
    want = driver.reference_readings(ctx, checked)
    out = {}
    for name, kwargs in planted.items():
        got = driver.reference_readings(ctx, checked, **kwargs)
        out[name] = driver.compare(got["losses"], got["first_grad"], got["change"],
                                   got["ema_change"], got["bn_change"], want)
        out[name].pop("where")
    return out


def control_numbers(ctx, driver, seed: int) -> dict:
    """The control in the program's place at the cell's size."""
    return planted_numbers(ctx, driver, seed, control={"control": True})["control"]


def fault_numbers(ctx, driver, seed: int) -> dict:
    """{fault: numbers} of each fault planted in the reference put in the
    program's place."""
    faults = {fault: {"fault": fault} for fault in driver.FAULTS}
    return planted_numbers(ctx, driver, seed, half={"rows": ctx.traffic["batch"] // 2}, **faults)


def main() -> None:
    """``readings.py``'s command line, with this file's control and faults
    in the place of its own (in the copy of ``readings.py`` loaded here)."""
    READINGS.control_numbers, READINGS.fault_numbers = control_numbers, fault_numbers
    READINGS.main()


if __name__ == "__main__":
    main()
