"""Input routes, one module a route, found by a cell's ``route`` key
(``registry.route``; ``cold`` where the cell names none). Each has
``open_pipeline(config, corpus, learner, model, device) -> (iterator,
cleanup)``: the pipeline that feeds the learner from the corpus written at
``corpus``, and a function that removes what the route left behind, which
the harness calls beside the corpus's removal whether or not the run
ended well. A route may do work of its own during set-up (a snapshot
written from a cold epoch, say); that counts as set-up. The iterator has
``__next__`` (``StopIteration`` at an epoch's end), ``reset()``,
``stats()`` and ``close()``, as ``DeviceIter`` has."""
