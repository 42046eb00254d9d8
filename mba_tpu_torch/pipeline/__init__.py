"""The pipeline layer of the port (``mba_tpu/pipeline``), one slice at a
time: ``signal_features``, ``preprocessing``, ``statistical_modelling``,
``cbpa``, the host integration layers ``data_integration`` and
``data_analysis``, and the plots of ``visualizations`` that the ported
workflows draw."""
