"""Roofline of the port's programs: the per-device cost of a program
counted as it runs (``op_cost``), the work of each hand-written kernel
(``kernel_cost``), the card's roofline terms (``analysis``) and the
tables of a dry run and of the card's runs (``report``)."""
