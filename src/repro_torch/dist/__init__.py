"""Distribution layer of the training stack: the sharding context
(``sharding``), the train step (``steps``), int8 gradient compression
(``compression``), the pipeline schedule (``pipeline``), and straggler
mitigation (``straggler``)."""
