"""Training (port of ``repro.training``): the step's loss and update
(``train_loop``), AdamW and Adafactor (``optimizer``) and checkpoints
(``checkpoint``)."""
