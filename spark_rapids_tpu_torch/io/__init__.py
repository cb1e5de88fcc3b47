"""File IO: the Parquet codec (``parquet.py``), the writer
(``writers.py``) and the directory naming the writers share
(``scans.py``)."""
