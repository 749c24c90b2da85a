"""The drivers of the traffic kinds: ``kinds/<kind>.py`` runs every cell
whose traffic file names that ``kind``, and exposes ``run(run) → dict``."""
