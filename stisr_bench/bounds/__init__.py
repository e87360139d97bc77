"""The least time of a kernel's launches, one file a kernel roofline.

A roofline spec, ``metrics/<name>.json`` beside the metrics
``<name>.<mode>`` that read it (:func:`stisr_bench.readers.roofline`),
names:

- ``module``: the dotted path of the program's layer class whose calls
  launch the kernel; a forward pre-hook on each of its instances records
  the launches of the profiled window (:mod:`stisr_bench.trace`);
- ``counters``: the dotted paths of the program's forward and backward
  launch counters, which the recorded launches have to match;
- ``kernels``: fragments of the names of the kernel's device functions,
  whose device seconds the least time is held against;
- ``bound``: a file ``bounds/<bound>.py`` of this folder with
  ``shapes(module, args) -> list[tuple]``, the shape of each launch of
  the kernel that one call makes ([] where the call launches none, as a
  BiGRU wider than the narrow kernels), and ``bound(shape, backward,
  peak) -> (seconds, "bytes" | "operations")``, the least time of one
  forward or backward launch against the card's row of ``peaks.json``.

A call recorded while autograd records and the layer has a parameter
that wants a gradient launches the backward kernel once per forward
launch.  A new kernel's roofline is a spec, a bound file and its metric
files: no edit elsewhere.
"""
