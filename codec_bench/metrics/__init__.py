"""Per-layer metric readers, one file each, found by the metric's name
(``<name>.py``, else the part of the name before its first dot).

A reader has ``NEEDS``, the traced passes it reads (``tracing``), and
``read(t, qualifier)``: the metric from ``t`` (``tracing.Traced``), the
qualifier being the part of the name after the first dot ("" if none), or
None where the cell gives it nothing to read."""
