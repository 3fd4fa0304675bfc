"""One module a driver: how a cell's window drives the program (``serve``,
``train``), named by the ``driver`` key of a traffic file."""
