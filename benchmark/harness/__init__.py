"""The benchmark's harness: finding a cell's parts by name (``spec``),
making its frames from the seed (``frames``), driving the program's
entry as its users do (one module a traffic kind, chosen by the mix's
``kind``: ``library``), host spans and the device trace (``spans``,
``trace``), the roofline counts (``roofline``), the check against the
plain reference (``check``, ``sample``), and one run (``runner``)."""
