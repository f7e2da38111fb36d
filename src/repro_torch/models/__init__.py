"""Dense transformer model code of the port (counterpart of ``repro.models``)."""
