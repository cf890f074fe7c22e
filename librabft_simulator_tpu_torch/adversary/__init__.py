"""The adversary plane: per-slot attack-schedule and network rows with their
decode (``plane``), and the attack-program DSL that lowers to them
(``dsl``)."""
