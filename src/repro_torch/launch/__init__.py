"""Entry points of the port (counterpart of ``repro.launch``):
``steps.make_train_step`` and the ``train`` CLI."""
