"""Learners, one module a model, found by a configuration's ``model`` key
(``registry.learner``). The harness steps the program's learner and knows
nothing else of it; each module gives:

- ``build(config, seed, device, log)``: the port's learner holding the
  seed's initial parameters (the program is imported here, never when the
  module is);
- ``pipeline_kwargs(model, config)``: the ``DeviceIter`` keywords its
  batches need, beside the batch size and the device;
- ``after_step(model, step, program)``: after each followed step, what the
  check reads of the learner's state into the ``program`` dict;
- ``after_followed(model, config, seed, device, program)``: the same once
  the followed steps are done, before the window;
- ``epoch_end(model)``: called in the window at each epoch's end, before
  the pipeline restarts;
- ``reference_readings(config, seed, ref_batches, program, device)``: the
  gaps between ``program`` and the reference over the followed batches;
- ``control_readings(config, seed, ref_batches, device)``: ``{side:
  readings}`` for the control and the faults planted in the reference put
  in the program's place (``calibrate.py``);
- ``faults()``: ``{name: fn(model, it) -> (model, it)}``, the faults planted
  in the program's timed path that must turn ``correct`` false (the tests
  run each on every cell of the learner);
- ``cpu_metrics``: the base names of the per-layer metrics that a CPU run
  of its cells reports (the tests look for them).

``ref_batches`` are the reference's parse in the form of the
configuration's ``layout`` (``harness.LAYOUTS``)."""
