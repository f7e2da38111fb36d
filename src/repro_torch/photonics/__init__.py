"""The optical subsystem of the port (counterpart of ``repro.photonics``).

Only what the behavioral OptINC collective needs is ported so far:
``encoding`` (block quantization and the Q(mean) of eq. 3).  The
symbol-level functions, the ONN, the MZI mesh and the pipeline stages
belong to the ``onn`` and ``mesh`` fidelities and come with them."""
