"""Host-side transforms of the port (counterpart of
``bigdl_tpu.transform``)."""
