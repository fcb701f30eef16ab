"""Drivers: how a traffic mix enters the program.  A traffic file names its
driver (``"driver": "<name>"``) and the harness imports
``portbench/drivers/<name>.py``, so a new entry kind is a new file.

A driver module gives:

* ``replay_ticks(cell) -> (ticks, grid)``: the ticks of one replay and the
  grid its chunk boundaries lie on (a periodic refresh's rate, else 1);
* ``Program(cell, net_arrays, pop, device, marks)``: the system under
  test built from the generated arrays, with ``net``, ``state0`` (the
  saved initial state), ``rows`` (agent rows a tick), ``network_s``
  (seconds of the network build), ``marked`` (the name of the callable it
  marks once a tick), ``replay_state(key)`` and ``run(state, ticks) ->
  (state, logs)``.  Its once-a-tick callable (and its refresh, where it
  has one) is wrapped so that each call records into ``marks``
  (:class:`portbench.harness.Marks`);
* ``Reference(cell, net_arrays, pop, device, lower=None)``: the plain
  reference built from the same arrays, with ``net``, ``physics``,
  ``policy``, ``initial(key=None)``, ``run(state, ticks)`` and
  ``adopt(x)`` (a program state as the reference's types); ``lower``
  stores its time stamps in that dtype after every tick (the control);
* optionally ``compare(ref, prog, kept, sp, key0)``, where the default
  comparison (:func:`portbench.check.compare`) does not fit.
"""
