"""One timed entry a module: ``Driver`` with ``setup``, ``call``, ``check``
and ``control``; a traffic mix names its driver."""
