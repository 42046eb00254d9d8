"""The pipeline layer of the port (``mba_tpu/pipeline``), one slice at a
time: ``signal_features``, ``preprocessing``, ``statistical_modelling``,
the omnibus workflow's plots in ``visualizations``, and the host helpers
they need."""
