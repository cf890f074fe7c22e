"""Observability of a run: the metrics plane and flight recorder
(``plane``), the digest, watchdog plane and timeline (``stream``), the
frozen slot-map versions (``schema``) and the run report (``report``)."""
