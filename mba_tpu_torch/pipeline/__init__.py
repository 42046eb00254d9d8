"""The pipeline layer of the port (``mba_tpu/pipeline``), one slice at a
time: ``signal_features`` and the host helpers it needs."""
