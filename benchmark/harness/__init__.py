"""The benchmark's own code: finding a cell's files by name, seeded weights
and inputs, the trace's reduction, the byte and operation counts, and the
comparison that decides ``correct``.  It reads the program
(``fm3dgan_torch``) only through the entry points that the drivers call."""
