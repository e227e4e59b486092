"""Traffic: one data file a mix (``<name>.json``), read by the module its
``kind`` names (``<kind>.py``).

A module says which driver runs it (``DRIVER``: ``"serve"`` or
``"train"``).  A training kind gives ``corpus(mix, seed, vocab)``.  A
serving kind gives, and the serving driver names no kind:

- ``schedule(mix, cell, seed, seconds, vocab)``: every request of the run
  (``at``, seconds from the window's start, negative before it;
  ``prompt``, token ids; ``max_new``);
- ``feed(plan, mix, t0, stop, submit)``: the threads that send the plan,
  unstarted; each calls ``submit(item, due)`` (``due`` on the host's
  clock) for a request and gets back its record, and ends once ``stop``
  is set;
- ``settle(mix, served, t0, t1)``: called when the window closes, returns
  once the load has done what the window owes (the open loop: every
  request due in the window finished, or its tail spent);
- ``account(run)``: the requests the run attempted, and how many of them
  failed.

Every serving mix has ``lead_in_s``: the traffic starts that long before
the window.
"""
