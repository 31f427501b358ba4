"""Architecture configurations of the port (copies of the reference's).

``registry.get_config(name)`` / ``smoke_config(name)`` return the same
``ArchConfig`` values as the reference package's registry; the port keeps
its own copy so that it imports nothing of the reference.
"""
