"""Observability of a run: the metrics plane and flight recorder
(``plane``), the digest, watchdog plane and timeline (``stream``), the
frozen slot-map versions (``schema``), the run report (``report``) and the
host-side runtime ledger of spans and builds (``ledger``)."""
