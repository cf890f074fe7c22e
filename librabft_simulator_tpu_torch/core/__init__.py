"""Protocol layers: types, config, store, pacemaker, data sync, node."""
