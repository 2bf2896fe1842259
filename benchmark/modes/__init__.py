"""Traffic modes that a cell brings as files.

A traffic file (``traffic/<name>.json``) whose ``mode`` is not built into
``load.MODES`` names the file ``modes/<mode>.py`` here, found by name and
loaded by path, as ``run.reader`` loads a metric.  The name is a plain
file name: letters, digits, ``_``, ``-`` and ``.``, with no ``/`` and no
``..``; a name that is not, or a file that is missing, fails the run
(``benchmark.Failed``).  So a new cell can bring a mode with no edit to
the harness.

A mode file defines

``run(run, seconds, profile, dev)``
    with the contract of the built-in modes in ``load``: make the
    inputs from ``run.seed``, set up and warm every shape the window
    will use (set-up, counted in ``setup_s``); measure inside
    ``load._window(run, profile, dev)`` for ``seconds`` (a traced run,
    ``run.trace_on``, for its traffic's fixed count instead); fill
    ``run.requests`` (``(kind, start, end, MP)``), ``run.answers``
    (``(key, "stream" | "pixels", value)``), ``run.attempted`` and
    ``run.answered``; set ``run.check_keys`` to the keys the check
    compares (``load._check_keys`` draws them from the seed); and return
    the program's state, which the harness frees before the check.

``reference(run, quota, workers, control)``, optional
    the expected results of the checked keys, ``{key: {"stream": bytes,
    "pixels": array}}``, as ``check.reference`` gives them for grayscale
    frames; ``check.run_check`` then takes them from here, and
    ``check.compare`` judges the answers against them (a pixel answer
    that is a tuple of planes, as colour's ``(y, u, v)``, is compared
    with a stacked ``(planes, h, w)`` array).  ``control`` is ``None``
    or one of ``check.CONTROLS``, and the reference must put that fault
    in: the controls have to fail through this hook as they fail through
    ``check.reference``.  Without it the grayscale ``check.reference``
    judges the cell, from ``check.checked_frames``.

A reference is plain NumPy under ``benchmark/reference/``: it imports
nothing of the program (``icer_compression_tpu_torch``), nor torch, JAX
or the JAX package, and takes nothing the program has made.  Import the
harness as ``from benchmark import check, frames, load``.
"""
