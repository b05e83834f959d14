"""CN-DPM constants (counterpart of ocl_tpu/models/ndpm_vars.py; reference
utils/global_vars.py:1-25). Read through the module at call time, so a test
can patch VAE_Z_SAMPLES."""

VAE_NF_BASE = 32
VAE_NF_EXT = 4
VAE_Z_DIM = 64
VAE_RECON_LOSS = "gaussian"
VAE_X_LOG_VAR_PARAM = 0.0
VAE_Z_SAMPLES = 16
CLS_NF_BASE = 20
CLS_NF_EXT = 4
SLEEP_BATCH_SIZE = 50
SLEEP_STEP_G = 4000
SLEEP_STEP_D = 1000
WEIGHT_DECAY = 0.00001
LR_GAMMA = 0.2          # MultiStepLR(milestones=[1], gamma=0.2): wake updates
LR_MILESTONES = (1,)    # scheduler epochs at which gamma applies
CLIP_VALUE = 0.5        # clip-grad-by-value
