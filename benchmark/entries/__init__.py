"""The program's entries, one module per traffic mix's `entry`, found by
that name (`Manifest.entry`). A module gives:

  Entry(model, traffic, device, seed, config)
      `run(k)` serves input k from host inputs to a host result and
      returns its seconds; `capture(k)` keeps input k's outputs for the
      check (called for the inputs `sample` names); `outputs()` is what
      the check reads, on the host; `close()`.
  MODULE_RANGES
      whether the traced span opens module ranges (`harness/trace.py`).
  sample(mix, seed)
      the window's inputs (offsets from its first) whose outputs the
      check compares.
  check(config, traffic, outputs, seed, device)
      the numbers compared against the reference (`harness/check.py`).
  work(config, traffic, seed, device, k)
      the FLOPs of input k on the reference (`counts/work.py`).
  controls(config, traffic, seed, device, ks)
      {reading: numbers} of the control and the planted faults in the
      program's place (`control.py`), for the compared inputs ks.

A new entry is a new module here and a mix that names it.
"""
