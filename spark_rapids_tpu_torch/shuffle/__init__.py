"""Shuffle subsystem: the kudo wire format (``serde.py``), the spillable
shuffle store (``store.py``) and the cross-process exchange over shuffle
files (``exchange_files.py``); counterpart of ``spark_rapids_tpu/shuffle``
(reference SURVEY.md §2.7)."""
