"""Frozen MVM teachers of the port (counterparts of
``empirical_mvm_tpu/teachers/``)."""
