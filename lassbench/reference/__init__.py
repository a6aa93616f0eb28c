"""The plain float32 reference of the benchmark's configurations.

Plain PyTorch, written from the published models (AudioSep's ResUNet30,
LAION-CLAP's RoBERTa text branch and HTSAT audio branch) with the state-
dict names of their checkpoints; it imports nothing of the program and
takes nothing the program made: the benchmark hands both sides the same
seeded weights and inputs. Every function here runs in IEEE float32
(callers turn TF32 off) unless a control asks for a lower precision.
"""
