from geossl_tpu_torch.objectives.autoencoder import AutoEncoder
from geossl_tpu_torch.objectives.contextpred import (
    context_masks,
    contextpred_loss,
    hop_distances,
    sample_centers,
)
from geossl_tpu_torch.objectives.contrastive import (
    cycle_shift,
    do_cl,
    dual_cl,
    dual_infonce_loss,
    ebm_nce_loss,
    infonce_loss,
    l2_normalize,
    perturb_positions,
)
from geossl_tpu_torch.objectives.heads import (
    ChargePredictor,
    DistancePredictor,
    TorsionAnglePredictor,
    charge_loss,
    charge_masking,
    distance_loss,
    torsion_loss,
    torsion_triples,
)
from geossl_tpu_torch.objectives.infograph import (
    InfoGraphDiscriminator,
    infograph_loss,
)
from geossl_tpu_torch.objectives.ncsn import NCSNv1, NCSNv2, NCSNv3, sigma_ladder
from geossl_tpu_torch.objectives.pairs import graph_pair_counts, pair_selection
