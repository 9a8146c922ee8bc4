"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Runs from the root of a checkout, needs one card and no network, and imports
nothing of JAX. It drives two paths of the AVE eval forward: the default
path (K1 window attention + K2 MLP block in every Swin block) and the chain
path, `AVEModel(cfg, block_chains=True)` (K3 block chains, K2 at the adapter
seams); then the AVE train step on the default path (K1 and K2 forward, the
backward kernels K1b and K2b); then a reference checkpoint converted and
loaded into the same AVE model, and the audio-statistics tool on the card
(phases 31, 32); then the rest of AVE (its other head
settings, the scv2 / Swin-V2-B flavor) and AVE's driver,
`python -m avmoe_tpu_torch.cli.train_ave`, run in-process to train, test
and resume at full width; then AVE's legacy models, MMIL_Net v1 (one DG-SCT
adapter per site and side, every stage) and the LAVisH MMIL_Net_v2 (one
Swin-V2 over both streams), their eval forwards and train steps and their
drivers (`train_ave --model v1|lavish`); then AVVP, `MGNModel(AVVPConfig())`
(adapters in all four stages, bmm unimodal experts, grouping heads), its
eval forward and train step through the same kernels; then AVQA,
`AVQAFusionModel(AVQAConfig())` (three experts, an LSTM question encoder,
grounding heads, and the negative frames through the frozen Swin-V2 with no
adapters: K1 + K2 a block, or each stage as K3 chains), its eval forward on
both paths and its train step; then AVS, `AVSModel(AVSConfig())` (5 frames
a clip at 224 px, adapters in all four stages with 'mha' unimodal experts,
each stage's tokens into TPAVI and an FPN decoder to 224-px masks; MS3 with
'token' experts), its eval forward on both paths and the MS3 and S4 train
steps (S4 trains HTS-AT: its weights' gradients come from K1b and K2b);
then the AVSBench baseline, `AVSBaselineModel` with a PVT-v2-b5 and with a
ResNet-50 encoder in float32, fed by the port's VGGish from the wave, its
eval forward and S4 train step (no kernel of the port on its path), and the
slice's other modules (legacy backbones, attention zoo, losses) card vs
CPU; last the AVVP, AVQA (its grounding stage too) and AVS drivers, run
in-process to train, test and resume at full width.
Phases (any failed check raises, and the
script exits non-zero without printing the result line). Of the profiles
the list below names, only the windows in `PROFILED` are traced (AVE's
default-path eval and train step, both again on the fused combine, the
AVVP, AVQA and AVS S4 train steps, AVQA's negative pass and TPAVI); the
others report "not profiled", to keep the script inside its time limit:

  1. card: nvidia-smi name and power limit, torch / CUDA versions;
  2. build: the four CUDA sources with nvcc (one process each, in parallel);
     the tensor-core instructions in the SASS of K1, K2, K3 and K1b: HMMA
     (mma.sync) in each, and HGMMA (wgmma, K2b's products) in the mlp_block
     library; ptxas registers and spills per instantiation of K1b and of
     K2b's wgmma product, none of K1b's bf16 ones nor of the wgmma ones
     spilling;
  3. window-attention kernel vs its plain version at every main-path shape,
     float32 (rtol 1e-4, atol 1e-5) and bfloat16 (|d| <= 2e-2 (1 + |ref|)
     against the float32 plain version of the same bf16 inputs);
  4. MLP-block kernel vs its plain version, the same way (TF32 off); per
     shape also a train forward's time (fc1's pre-activation h1 kept for
     K2b), its two products alone at each output tile width (the one the
     wrapper picks marked) and, as a products-only yardstick, two cuBLAS
     bf16 products (F.linear fc1, F.linear fc2: no GELU, no LN, no
     residual, so not a call that computes the block);
  5. block-chain kernel vs its plain version at every chain geometry of the
     chain path (seeded blocks), float32 (|d| <= 1e-4 + 1e-4 |ref|) and
     bfloat16 (|d| <= K3_BF16_TOL (1 + |ref|) against the float32 plain
     version of the same bf16 inputs);
  6. tiny AVE model in float32, both paths: card (kernels) vs CPU (plain
     versions) on the same weights, rtol 1e-3, atol 1e-4;
  7. full AVEConfig() in bfloat16 at batch 4 and 1 clips, both paths, seeded
     weights with non-zero gates: output shapes, finiteness, gating probs
     summing to 1, K1 / K2 / K3 launches per forward as the injection plan
     gives them, cosine >= 0.99 of the logits against a float32 forward of
     the same path and weights, and of the chain path against the default;
  8. times (reported, not claimed): per path eval clips/s at batch 4 and
     batch-1 p50; per kernel and shape the kernel, plain-version and bound
     times (and for window attention the time of
     scaled_dot_product_attention);
  9. profile, per path: device time per batch-4 forward by kernel
     (torch.profiler) and the device's idle share of the forward's wall time,
     and the host's side of the window (its CUDA runtime calls by name and
     its ops by self CPU time), as every later profile;
 10. K1b (window-attention backward; input gradients here, the frozen
     backbones' case) against the plain version's autograd at
     every main-path shape, float32 (rtol 1e-4, atol 1e-5) and bfloat16
     (|d| <= 2e-2 (1 + |ref|) against the float32 plain autograd of the same
     bf16 inputs); times beside the plain autograd's, the bound and the
     backward of scaled_dot_product_attention with a float mask, with the
     achieved TFLOP/s and the share of the bound;
 11. K2b (MLP-block backward; dx here, the frozen backbones' case) the same
     way at every main-path shape, both
     norms, with and without a DropPath scale that has zeros in it (K2's
     forward with the scale checked too); times, from the forward's kept h1
     (and f on V2), beside the plain autograd's, the bound, its two wgmma
     products alone at each tile width and cuBLAS's for the same products;
 12. tiny AVE model in float32, deterministic (AVMOE_DETERMINISTIC_TRAIN=1):
     4 train steps on the card (kernels) against 4 on the CPU (plain
     versions) from the same weights and batches, mixup λ given: losses
     rtol 1e-3, trainable parameters and running stats rtol 1e-3, atol 1e-4;
 13. full AVEConfig() train step in bfloat16 at batch 4 on the default path,
     seeded weights with non-zero gates, DropPath, SpecAugment, dropout and
     mixup on: 3 steps with finite losses, every frozen parameter
     bit-identical after them, every trainable one moved, bn0's and the
     adapters' running stats moved, K1 / K2 / K1b / K2b launches per step as
     the injection plan gives them; then one deterministic step in bf16
     against the same step in float32 at the seeded init (adapter gates
     zero, where training starts): cosine >= 0.99 of the flattened
     trainable gradients;
     times (reported, not claimed): train step ms and
     clips/s, peak memory, and a torch.profiler split of one step's device
     time by kernel;
 14. the tiny AVE model with each head setting of the rest of AVE
     (is_inter_in_cmbs=True: AudioVideoInter in CMBS; is_temporal_att=
     False: ReLU Linear heads; is_cmbs=False: the classification path's
     segment_probs), float32, card (kernels) vs CPU (plain versions), every
     output and the gating probs rtol 1e-3, atol 1e-4;
 15. ave_flavor_config("scv2", "base") (HTS-AT at 16 kHz, hop 160; Swin-V2-B,
     widths 128 to 1024) at full width in bf16: the batch-4 and batch-1 eval
     forwards with the launches of the plan (36 / 36 / 0), the bf16-vs-fp32
     logits cosine >= 0.99, three train steps with K1b / K2b as planned,
     frozen weights bit-identical and every trainable one moved;
 16. the AVE driver, `avmoe_tpu_torch.cli.train_ave.main`, in-process on the
     full AVEConfig() in bf16, three times, each under a process group of
     world size 1 on NCCL (RANK / WORLD_SIZE set as torchrun sets them; the
     gradient all-reduce counted at every step, the group ended after
     main): train (--synthetic --batch_size 4 --accum_itr 2 --epochs 1
     --decay_epoch 1 --num_workers 4: 8 micro-steps, 4 Adam updates, 2 eval
     batches of 4), with finite losses,
     the updates' learning rates lr read from the optimizer,
     frozen parameters bit-identical to the initial ones and every trainable
     one moved, best.json and at most 3 step directories, the 12
     expert_stats_*.npy files with each mean_gating_probs row summing to 1
     within 1e-3, the K1 / K2 / K1b / K2b launches over the run equal to 8
     steps' and 2 eval forwards' plans, no jax imported, and nothing of the
     run left allocated on the card after main returns; --mode test, whose
     accuracy equals best.json's metric; --resume --epochs 2, whose restored
     state equals the saved checkpoint bit for bit (weights, running stats,
     Adam moments, acc_grads, step, updates) and whose second epoch ends
     with finite losses at the updates' learning rate lr * decay (the step
     decay). Reported (not claimed): the loop's median step wall
     time beside phase 13's step time, the consumer's mean wait on the
     loader a step, one checkpoint's size and its save and restore times,
     and the peak memory;
 17. tiny MGNModel (AVVP) in float32: the eval forward on both paths, card
     vs CPU, every output, gating probs and lb_loss rtol 1e-3, atol 1e-4;
     one deterministic step's trainable gradients card vs CPU (cosine and
     every leaf >= 0.9999) and a 2-step train curve (as phase 12), the
     heads' DropPath off and HAN's Gumbel noise given on both;
 18. full AVVPConfig() in bfloat16 on the default path at batch 4 and 1
     clips, seeded weights with non-zero gates, gate_av and class tokens:
     K1 / K2 / K3 launches per forward as the plan gives them (36 / 36 /
     0), shapes, finiteness, gating sums, lb_loss; cosine >= 0.99 of the
     pooled encoder features f_v and f_a against a float32 forward; the
     heads' largest differences and HAN's flipped straight-through
     assignments (reported: an argmax is discontinuous); the F1 suite of
     make_avvp_eval_fn finite; times and a profile as in phases 8 and 9;
 19. the full AVVPConfig() bf16 train step at batch 4 (DropPath, SpecAugment,
     dropout, Gumbel noise, mixup on): K1 / K2 / K1b / K2b launches per step
     (36 / 36 / 34 / 35), frozen parameters bit-identical, every trainable
     one moved, bn0's running stats moved; one deterministic step's
     trainable gradients in float32 through the kernels against their plain
     versions at the seeded init, cosine >= 0.9999 overall and on every
     leaf (bf16 vs fp32 there reported); step ms, clips/s, peak memory and
     a profile;
 20. K3 against its plain version at the AVQA chain geometries the AVE chain
     path does not run, as phase 5 holds them; stage 2's 18 blocks as one
     chain in bf16 within K3_BF16_TOL sqrt(K / 2) of the float32 plain
     version and no farther than the plain version in bf16 is
     (`k3_bf16_budget`); with times;
 21. tiny AVQAFusionModel in float32: the eval forward on both paths, card
     vs CPU (every output and the gating probs rtol 1e-3, atol 1e-4), its
     launches as `avqa_kernel_launches` gives them; one deterministic
     step's trainable gradients card vs CPU (cosine and every leaf >=
     0.9999) and a 2-step train curve (as phase 12);
 22. full AVQAConfig() in bfloat16 on both paths at batch 4 and 1 clips
     (positive and negative frames (4, 10, 192, 192, 3), waves (4, 10,
     32000), questions (4, 30)), seeded weights with noised gates and
     gate_av: K1 / K2 / K3 launches per forward (60 / 60 / 0 and 0 / 12 /
     36), shapes, finiteness, gating sums; cosine >= 0.99 of qa_logits, of
     the pooled encoder features and of the negative pass's pooled features
     against a float32 forward of the same path and weights, and of the
     chain path's qa_logits against the
     default's; the match logits' differences (reported); the accuracy of
     make_avqa_eval_fn; times, the negative pass alone (CUDA events and a
     profile) and a profile per path;
 23. the full AVQAConfig() bf16 train step at batch 4 (DropPath,
     SpecAugment, dropout and mixup on): K1 / K2 / K1b / K2b launches per
     step (60 / 60 / 34 / 35: the negative pass launches no backward),
     frozen parameters bit-identical, every trainable one moved, bn0's
     running stats moved; one deterministic step's trainable gradients in
     float32 through the kernels against their plain versions at the seeded
     init, cosine >= 0.9999 overall and on every leaf (bf16 vs fp32
     reported); step ms, clips/s, peak memory and a profile;
 24. every kernel of the AVS path against its plain version at AVS's own
     shapes (5 frames a clip, where the phases above run 10): K1, K2 and K3
     (every AVS chain geometry) at a batch-4 (20 frames) and a batch-1 (5
     frames) forward's, K1b and K2b at the batch-4 MS3 step's, with the
     bounds of phases 3 to 5, 10 and 11 and with times; the calls per shape
     sum to the AVS plans (`phase_avs_kernels`); then the parameter
     gradients a trainable backbone needs, at the batch-4 S4 step's HTS-AT
     shapes (every stage, shifted and unshifted) and one Swin-V2 shape:
     K1b's dbias (`phase_k1b_bias`) and K2b's dW1, db1, dW2, db2, d ln_w,
     d ln_b (`phase_k2b_params`, both norms, with and without a DropPath
     scale that has zeros), against the plain versions' autograd, float32
     |d| <= 1e-5 sqrt(terms) + 1e-4 |ref| (terms: the frames a window's
     bias sums, or the rows) and bf16 max |d| <= 2e-2 (1 + max |ref|),
     bit-identical across two calls; times with and without them (K2b's
     two float32-output cuBLAS weight products alone too) and the bound;
 25. tiny AVSModel in float32, S4 and MS3, 80-px frames resized to 64 and
     the stage grids to a (24, 12, 6, 3) pyramid: the eval forward on both
     paths, card vs CPU (the mask logits, the four feature maps, the
     aligned audio, gating probs and lb_loss rtol 1e-3, atol 1e-4; for S4,
     whose 'mha' expert turns rounding into more, up to 4x the CPU's own
     change under a 1e-6 relative input change where that is larger), its
     launches as `avs_kernel_launches` gives them; MS3's and S4's (HTS-AT
     trainable, through K1b's dbias and K2b's weight gradients on the card)
     one deterministic step's trainable gradients card vs CPU and a 2-step
     train curve (as phase 12), the router noise given on both; an S4 leaf
     below 0.9999 passes where 1 - its cosine is within 4x the CPU's own
     largest 1 - cosine of a leaf under a 1e-6 relative input change (the
     'mha' expert), the whole gradient's cosine still >= 0.9999;
 26. full AVSConfig() (S4) in bfloat16 on both paths at batch 4 and 1 clips
     (frames (4, 5, 224, 224, 3), waves (4, 5, 32000)), seeded weights with
     noised gates and W_z_bn scales: K1 / K2 / K3 launches per forward (36 /
     36 / 0 and 0 / 12 / 30), shapes, finiteness, gating sums, lb_loss;
     cosine >= 0.99 of the mask logits and of each stage's pooled tokens
     against a float32 forward at the same batch, of the chain path's mask
     logits against the default's; the MS3 config at batch 4 on the default
     path the same way; mask IoU and F-measure of make_avs_eval_fn on
     synthetic masks (reported); times, TPAVI's four calls alone (CUDA
     events and a profile) and a profile per path;
 27. the full MS3 bf16 train step at batch 4 (DropPath, SpecAugment,
     dropout, router noise and mixup on): K1 / K2 / K1b / K2b launches per
     step (36 / 36 / 34 / 35), frozen parameters bit-identical, every
     trainable one moved, bn0's and W_z_bn's running stats moved; the fp32
     gradient gate of phase 20; step ms, clips/s, peak memory and a profile;
     then the full S4 bf16 train step at batch 4, HTS-AT trainable, the
     same way: K1b / K2b launches per step as `avs_backward_launches` gives
     them (every HTS-AT sub-block), Swin bit-identical, every trainable
     parameter moved (every HTS-AT block's relative-position table, fc1,
     fc2 and norm2 among them), the fp32 gradient gate on every leaf,
     HTS-AT's included;
 28. the AVVP driver, `avmoe_tpu_torch.cli.train_avvp.main`, in-process on
     the full AVVPConfig() in bf16 (--synthetic --batch_size 4 --accum_itr
     2: 8 micro-steps an epoch, the F1 suite over 2 eval batches): 1 epoch
     with the K1 / K2 / K1b / K2b launches of 8 steps' and 2 eval
     forwards' plans, finite losses, frozen parameters bit-identical, every
     trainable one moved, best.json and the 12 expert dumps; --mode test,
     whose F1 suite equals that of the best step's evaluation in the train
     run, all ten numbers; --resume --epochs 2, whose restored state equals
     the latest checkpoint bit for bit; nothing of a run left allocated on
     the card after main returns; the loop's median step beside
     phase 19's, the loader's wait, a checkpoint's size, save and restore
     times, the peak memory (as phase 16 reports them);
 29. the AVQA driver, `cli/train_avqa.py`, on the full AVQAConfig() in
     bf16: --stage grounding for an epoch (8 micro-steps of 40 one-segment
     samples: K1 / K2 60 / 60 a step from HTS-AT's 12 blocks and Swin-V2-L's
     24 twice, no K1b or K2b; Swin-V2 and HTS-AT bit-identical, the heads
     moved, bn0's running stats moved), then --stage avst --grounding_ckpt
     from its checkpoint directory (the seven grafted heads equal the
     grounding checkpoint's bit for bit at the first step; an epoch with
     the per-type accuracy, launches as planned), then --resume to a
     second epoch (the restored state bit-identical; every trainable tensor
     moved over the two runs); stage B with SpecAugment and dropout off
     (AVMOE_DETERMINISTIC_TRAIN=1): at the seeded init SpecAugment's stripes
     make the first audio site NaN at the first update, in both packages'
     math (tests/test_torch_cli_seed_init.py); times as phase 28;
 30. the AVS driver, `cli/train_avs.py`: S4 on the full AVSConfig() in bf16
     for 1 epoch (4 micro-steps, HTS-AT training: K1b with dbias and K2b
     with weight gradients 12 a step each, every HTS-AT weight moved; the
     sources archived; 4 Adam updates: the 220 tensors that cannot move at
     the seeded init, `avs_seed_init_stalls`, unchanged; the others moved
     are counted: at the recipe's lr S4 collapses to a constant loss within
     a few updates, tools/s4_train_curve.py), --mode test --save_pred_mask
     (the 4.885-GB checkpoint restored; 40 mask PNGs; the best step's mIoU
     and F-measure exactly); then MS3 at the tiny config in float32 on the
     card (4 micro-steps and updates, launches as planned, every trainable
     tensor moved but its 36 that cannot, test mode's mIoU the best,
     --resume to a second epoch: the restored state bit-identical);
 31. (after 13, on its model) a full-width MMIL_Net-layout state dict from
     seeded noise (`tests/torch_reference_layout.py`: 24 Swin-V2-L blocks,
     12 HTS-AT blocks, 8 sites x 4 adapters, temporal_attn.*, CMBS.*, and
     keys of reference modules no converter reads), converted by
     `checkpoint/convert.py` `convert_mmil_net` and loaded in place: host
     seconds of both, the keys read and dropped, every tensor changed,
     every Swin block's cached bf16 MLP weights current; the batch-4 eval
     on both paths with the plan's launches, cosine >= 0.99 of the logits
     against a float32 model of the same weights, chain vs default too;
     then `graft_backbones` from timm- and HTS-AT-layout dicts ('sed_model.'
     stripped): every backbone tensor changed and nothing else, the caches
     current, the default path's cosine >= 0.99; the host's peak RSS;
 32. `cli/compute_audio_stats.py` over 32 synthetic 10-s packs at 16 kHz
     (192 bins, 5.2-ms shift) on the card and with --device cpu: mean and
     std within rtol 1e-4; the tool's wall times and fbank's frames per
     second on the card (16 packs, float64 and float32);
 33. (after 16) MMILNetV1(AVEConfig()) and MMILNetV2(AVEConfig()) in bf16
     at batch 4 (`phase_legacy`), seeded weights with noised gates and
     gate_av: the eval forward's K1 / K2 / K3 launches as planned (36 / 36
     / 0 and 48 / 48 / 0, `models/ave_legacy.py` `mmil_v*_kernel_launches`),
     output shapes and finiteness, LAVisH's probabilities summing to 1,
     cosine >= 0.99 of the logits (and LAVisH's probabilities) against a
     float32 forward of the same weights; eval wall ms and clips/s; three
     train steps with the recipes' draws (v1: DropPath, SpecAugment, mixup,
     from the noised gates; LAVisH: DropPath, from the seeded init: from
     noised gates its gradient explodes through stage 2 in both packages,
     tools/lavish_grad_conditioning.py, tools/legacy_grad_diagnosis.py):
     K1 / K2 / K1b / K2b launches a step as planned (36
     / 36 / 34 / 35 and 48 / 48 / 46 / 48), frozen weights bit-identical,
     every trainable tensor moved, the adapters' running stats (and v1's
     bn0) moved; step ms, clips/s, peak memory, v1's step profiled; v1's 48
     token projections' device time alone (profiled kernels, forward and
     forward + backward) beside the eval wall and the step's device busy;
 34. every distinct kernel shape those runs gave the four wrappers
     (`_kernel_shapes`) is one phases 3, 4, 10 and 11 hold against the
     plain versions at 40 frames; a shape of another frame count is held
     there by that kernel's phase at its frames (`phase_legacy_shapes`);
 35. the AVE driver with `--model v1` and `--model lavish`
     (`phase_legacy_cli`), in-process on the full AVEConfig() in bf16,
     three times each: train one epoch (--synthetic --batch_size 4
     --accum_itr 1: 8 micro-steps and updates, 2 eval batches; LAVisH's
     clips through `LAVisHView`'s fbank images in the loader's workers),
     with the launches of 8 steps' and 2 eval forwards' plans, finite
     losses, frozen parameters bit-identical, best.json, no jax imported,
     nothing left on the card; --mode test, whose accuracy is best.json's
     and whose per-batch accuracies equal that epoch's evaluation bit for
     bit; --resume --epochs 2, whose restored state equals the checkpoint
     bit for bit, and after which every trainable tensor has moved over
     the two runs (but `LEGACY_CLI_STALLS`); the loop's median step, the
     loader's wait, a checkpoint's size, save and restore times, the peak
     memory;
 36. (after 27) every module of the AVSBench baseline's slice in float32 at
     tiny configs, card vs CPU on the same weights and inputs, rtol 1e-3,
     atol 1e-4 (`phase_avs_baseline_tiny`): VGGish on 4 examples, PVT-v2-b0,
     ResNet at depths 1-1-1-1 in eval and train mode (with its running
     statistics), `AVSBaselineModel` with either encoder cut down (64-px
     frames, T = 2, channel 32): its outputs, then one S4 train forward's
     loss (rtol 1e-4), gradients (cosines as phase 12) and running
     statistics; the legacy backbones, the attention zoo, the audio-guided
     attention and every loss of the loss library (rtol 1e-4);
 37. the VGGish front end at full width (`phase_vggish_full`): waves (4, 5 x
     16000) through `waveform_to_examples` on the card, in float64, against
     the CPU's, |d| <= 1e-6 (1 + |ref|), then VGGish (seeded, float32) to (4,
     5, 128) embeddings, finite and >= 0; both timed (CUDA events);
 38. `AVSBaselineModel` at full width in float32, once with PVT-v2-b5 and
     once with ResNet-50 (`phase_avs_baseline`), seeded, frames (4, 5, 224,
     224, 3) and phase 37's embeddings: the eval forward (the pyramid at 56
     / 28 / 14 / 7, mask logits (20, 224, 224), the maps and the aligned
     audio, all finite); the S4 objective's gradients at the seeded init,
     every one finite and zero exactly on `baseline_seed_init_stalls`
     (TPAVI's W_z set and the aligned audio's projection); one S4 step with
     Adam over every parameter (PVT's DropPath on): a finite loss, every
     parameter moved but that set, every running variance moved; no kernel
     of the port launched (K1 to K2b counted over the phase); wall and
     CUDA-event ms of the eval forward and of the step, peak memory, each
     beside the card's name and power limit;
 39. (after 13, on its model) the fused bottleneck-rank MoE combine
     (`phase_fused_moe`, every MoEAdapter switched): the bf16 batch-4 eval
     forward fused vs materialized (logits and gating cosines >= 0.999, K1
     / K2 launches 36 / 36 on both routes, as planned); one float32 train
     step's trainable gradients fused vs materialized at the seeded init
     with the gates at 1e-2 scale (whole and every live leaf >= 0.9999,
     float64 sums on the card) and its running statistics
     (rtol 1e-3, atol 1e-4, every one moved); three bf16 fused train steps
     with phase 13's checks; both routes' eval and train-step walls, device
     busy (profiles "fused eval" and "fused train step"; the materialized
     ones are phases 9 and 13's) and peak memory, with the card's name and
     power limit;
 40. t-SNE (`utils/tsne.py`) of 200 pooled AVE features, card against CPU:
     the KL gradient at a mid-descent embedding with and without the
     exaggeration, and the default descent's first 3 iterations (each
     within 1e-4; later the descent is chaotic), and the default run's
     time;
 41. `parallel/dryrun.py` at world size 1 on NCCL: 3 tiny AVE train steps
     under a group of one against the same steps without one
     (the loss curve, and each step held from the one process's state: BN
     statistics, every leaf's gradient, weights), then an eval pass with
     telemetry;
 42. inside phases 17, 21 and 25, on their models, the fused combine on the
     default path: the eval outputs and one train step's gradients, card vs
     CPU (the curves run materialized).

The lines eight to two before the last are JSON objects of the AVVP, AVQA
and AVS numbers (the AVS one with the S4 step's under `s4_*`), of the
legacy models' and their drivers' (`ave_legacy`: `v1`, `lavish`, `v1_cli`,
`lavish_cli`), of the AVSBench baseline's (`avs_baseline`: `vggish`, `pvt`,
`resnet`, each with the card's name and power limit), of the fused
combine's and t-SNE's (`ave_fused_moe`, `tsne`) and of the AVE
driver's, the scv2 / Swin-V2-B flavor's and
the AVVP, AVQA and AVS drivers' (`ave_cli`, `ave_scv2_base`, `avvp_cli`,
`avqa_cli`, `avs_cli`) with phases 31 and 32 (`convert`, `audio_stats`),
the line before the last one with the per-kernel summary (AVE's launches
and, beside them, AVVP's, AVQA's, AVS's and the legacy models'
(`mmil_v1_launches`, `lavish_launches`), each kernel's error and times at AVS's
shapes under `avs_shapes`, and K1b's and K2b's parameter gradients at the
S4 step's shapes under `param_grads`); the last line is {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
BATCH = 4                        # clips; B' = BATCH * 10 frames
# bf16 K3 vs the float32 plain version of the same bf16 inputs. A K=2 chain
# rounds the inputs of 8 tensor-core products to bf16 (the qkv, proj, fc1
# and fc2 A operands of each block), runs its attention on TF32 operands,
# and the V2 post-norm rescales every sub-block's output to unit size, so K3
# lands above the 2e-2 of K1 and K2 at the Swin-V2 stage-2/3 chains, though
# it rounds less than the Pallas body does (measured errors in PERF.md)
K3_BF16_TOL = 4e-2


def k3_bf16_budget(geom, rel_plain: float) -> float:
    """The bf16 K3 bound, as max |d| / (1 + |ref|) against the float32 plain
    version of the same bf16 inputs: K3_BF16_TOL for chains of up to 2
    blocks. A longer chain (AVQA's negative pass runs stage 2's 18 blocks as
    one) rounds 4 products' inputs in every block, and its error grows about
    as the square root of its length (independent roundings): it is held to
    K3_BF16_TOL * sqrt(K / 2), 1.2e-1 at K = 18 where 7.9e-2 was measured,
    and to no farther from float32 than the plain version in bf16, which
    rounds where the Pallas body rounds (`rel_plain`, at least
    K3_BF16_TOL), whichever is tighter."""
    if geom.K <= 2:
        return K3_BF16_TOL
    return min(K3_BF16_TOL * math.sqrt(geom.K / 2), max(K3_BF16_TOL, rel_plain))


def log(*a):
    print(*a, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, peak: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(out: torch.Tensor, ref: torch.Tensor, dtype, what: str) -> float:
    d = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        ok = bool((d <= 1e-5 + 1e-4 * ref.abs()).all())
    else:
        ok = bool((d <= 2e-2 * (1.0 + ref.abs())).all())
    err = d.max().item()
    check(ok and math.isfinite(err), f"{what}: kernel disagrees with its plain version "
                                     f"(max |d| {err:.3e})")
    return err


# main-path shapes at BATCH clips (B' = 10 * BATCH frames)
def k1_shapes(bp: int):
    """(BW, H, N, D, nW, calls per forward) for every window-attention call."""
    out = []
    # Swin-V2-L: N=144 (12x12), D=32; stage 3 shrinks to the 6x6 grid (N=36)
    for res, H, depth in ((48, 6, 2), (24, 12, 2), (12, 24, 18), (6, 48, 2)):
        w = min(12, res)
        nW = (res // w) ** 2
        shifted = depth // 2 if res > 12 else 0
        out.append((bp * nW, H, w * w, 32, 1, depth - shifted))
        if shifted:
            out.append((bp * nW, H, w * w, 32, nW, shifted))
    # HTS-AT: N=64 (8x8), D=24; stage 4 grid = window, no shift
    for res, H, depth in ((64, 4, 2), (32, 8, 2), (16, 16, 6), (8, 32, 2)):
        nW = (res // 8) ** 2
        shifted = depth // 2 if res > 8 else 0
        out.append((bp * nW, H, 64, 24, 1, depth - shifted))
        if shifted:
            out.append((bp * nW, H, 64, 24, nW, shifted))
    return out


def k1b_shapes(bp: int):
    """(BW, H, N, D, nW, launches per train step) of K1b, at every K1 shape:
    every K1 call of a forward but the first block of each backbone, whose
    input needs no gradient (moe/injection.py backward_launches)."""
    out = [list(s) for s in k1_shapes(bp)]
    first_htsat = next(i for i, s in enumerate(out) if s[2] == 64)
    for i in (0, first_htsat):
        out[i][-1] -= 1
    return [tuple(s) for s in out]


def k2_shapes(bp: int):
    """(rows, C, pre_norm, calls per forward) for every MLP sub-block."""
    swin = [(bp * 48 * 48, 192, False, 2), (bp * 24 * 24, 384, False, 2),
            (bp * 12 * 12, 768, False, 18), (bp * 6 * 6, 1536, False, 2)]
    htsat = [(bp * 64 * 64, 96, True, 2), (bp * 32 * 32, 192, True, 2),
             (bp * 16 * 16, 384, True, 6), (bp * 8 * 8, 768, True, 2)]
    return swin + htsat


def k2b_shapes(bp: int):
    """(rows, C, pre_norm, launches per train step) of K2b: every K2 call of a
    forward but HTS-AT's first block (moe/injection.py backward_launches)."""
    out = [list(s) for s in k2_shapes(bp)]
    first_htsat = next(i for i, s in enumerate(out) if s[2])
    out[first_htsat][-1] -= 1
    return [tuple(s) for s in out]


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")
    log(_card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def ptxas_report(text: str, cxxfilt: Path):
    """(kernel, registers, spill store bytes, spill load bytes) of every entry
    function in an nvcc -Xptxas -v log, the names demangled where cu++filt can."""
    rows, name, spills = [], None, (0, 0)
    for ln in text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", ln):
            name, spills = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", ln)) and name:
            rows.append([name, int(m.group(1)), *spills])
            name = None
    if rows and cxxfilt.exists():
        names = subprocess.run([str(cxxfilt), *(r[0] for r in rows)], capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                for noise in ("void ", "(anonymous namespace)::", "<unnamed>::", "(int)"):
                    n = n.replace(noise, "")
                r[0] = n.split("(")[0]
    return rows


def phase_build():
    from avmoe_tpu_torch.kernels import _build

    secs = _build.build(["window_attention", "mlp_block", "block_chain", "window_attention_bwd"])
    regs = []
    for name, text in sorted(_build.BUILD_LOGS.items()):
        regs += [f"{name}: {ln.split(':', 1)[1].strip()}" for ln in text.splitlines()
                 if "Used" in ln and "registers" in ln]
    log(f"[build] {secs:.1f} s; ptxas: " + " | ".join(regs))
    # K1b per instantiation: its bf16 (tensor-core) kernels must not spill
    cxxfilt = Path(_build.nvcc_path()).with_name("cu++filt")
    k1b = ptxas_report(_build.BUILD_LOGS["window_attention_bwd"], cxxfilt)
    for fn, nreg, st, ld in k1b:
        log(f"[build] K1b {fn}: {nreg} registers, spill stores {st} B, spill loads {ld} B")
    mma_fns = [r for r in k1b if "window_attention_bwd_mma_kernel" in r[0]]
    check(len(mma_fns) > 0, "no bf16 K1b kernel in the ptxas report")
    check(all(st == 0 and ld == 0 for _, _, st, ld in mma_fns),
          f"a bf16 K1b instantiation spills: {mma_fns}")
    # K2b's bf16 products (wgmma, gemm_wgmma.cuh): no spills either
    wg = [r for r in ptxas_report(_build.BUILD_LOGS["mlp_block"], cxxfilt)
          if "mlp_gemm_wgmma" in r[0]]
    for fn, nreg, st, ld in wg:
        log(f"[build] K2b {fn}: {nreg} registers, spill stores {st} B, spill loads {ld} B")
    check(len(wg) > 0, "no wgmma product kernel in the mlp_block ptxas report")
    check(all(st == 0 and ld == 0 for _, _, st, ld in wg),
          f"a wgmma product instantiation spills: {wg}")
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    counts = {}
    for name in ("window_attention", "mlp_block", "block_chain", "window_attention_bwd"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True, timeout=300).stdout
        counts[name] = {op: sum(1 for ln in sass.splitlines() if op in ln)
                        for op in ("HMMA", "HGMMA")}
    log("[build] tensor-core instructions in the SASS (HMMA: mma.sync, HGMMA: wgmma): "
        + ", ".join(f"{k} {v['HMMA']} / {v['HGMMA']}" for k, v in counts.items()))
    check(all(v["HMMA"] > 0 for v in counts.values()), f"no HMMA instructions in {counts}")
    check(counts["mlp_block"]["HGMMA"] > 0, "no HGMMA (wgmma) instructions in mlp_block")


def phase_k1(gen, frames: int = BATCH * 10, tag: str = "K1"):
    """K1 against its plain version at every window-attention shape of a
    forward over `frames` frames, float32 and bf16, with times."""
    from avmoe_tpu_torch.kernels.window_attention import window_attention, window_attention_plain

    dev = "cuda"
    max_err = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0)
    for BW, H, N, D, nW, calls in k1_shapes(frames):
        q32 = torch.randn(BW, H, N, D, device=dev, generator=gen) * 0.3
        k32 = torch.randn(BW, H, N, D, device=dev, generator=gen) * 0.3
        v32 = torch.randn(BW, H, N, D, device=dev, generator=gen)
        bias = torch.randn(nW, H, N, N, device=dev, generator=gen)
        shape = (BW, H, N, D, nW)
        compare(window_attention(q32, k32, v32, bias),
                window_attention_plain(q32, k32, v32, bias), torch.float32, f"{tag} f32 {shape}")
        q, k, v = q32.bfloat16(), k32.bfloat16(), v32.bfloat16()
        ref = window_attention_plain(q.float(), k.float(), v.float(), bias)
        err = compare(window_attention(q, k, v, bias), ref, torch.bfloat16,
                      f"{tag} bf16 {shape}")
        max_err = max(max_err, err)
        ms = time_ms(lambda: window_attention(q, k, v, bias))
        plain_ms = time_ms(lambda: window_attention_plain(q, k, v, bias))
        mask = bias.repeat(BW // nW, 1, 1, 1).bfloat16()
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                scale=1.0))
        nbytes = 4 * BW * H * N * D * 2 + nW * H * N * N * 4
        ops = 4 * BW * H * N * N * D
        b_ms, b_by = bound(nbytes, ops, BF16_FLOPS)
        log(f"[{tag}] BW,H,N,D,nW={shape} x{calls}/fwd  bf16 {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"sdpa {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  err {err:.2e}")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                         ("library_ms", lib_ms), ("bytes", nbytes), ("ops", ops)):
            tot[key] += calls * val
    return max_err, tot


def phase_k2(gen, frames: int = BATCH * 10, tag: str = "K2"):
    """K2 against its plain version at every MLP sub-block shape of a forward
    over `frames` frames, float32 and bf16, with times (its products alone
    at each tile width, and cuBLAS's)."""
    from avmoe_tpu_torch.kernels.mlp_block import (
        TILE_WIDTHS, busiest_sm_tiles, ctas_per_sm, mlp_block, mlp_block_plain, pick_tile,
        product_bf16, sm_count)

    dev = "cuda"
    sms = sm_count(torch.cuda.current_device())
    log(f"[{tag}] {sms} SMs; CTAs per SM of the product kernel by tile width: "
        + ", ".join(f"{w}: {ctas_per_sm(w)}" for w in TILE_WIDTHS))
    max_err = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, products_ms=0.0, cublas_ms=0.0,
               train_ms=0.0, bytes=0.0, ops=0.0)
    for R, C, pre, calls in k2_shapes(frames):
        Hd = 4 * C
        x32 = torch.randn(R, C, device=dev, generator=gen)
        lw = 1.0 + 0.1 * torch.randn(C, device=dev, generator=gen)
        lb = 0.1 * torch.randn(C, device=dev, generator=gen)
        w1 = torch.randn(Hd, C, device=dev, generator=gen) / math.sqrt(C)
        b1 = 0.1 * torch.randn(Hd, device=dev, generator=gen)
        w2 = torch.randn(C, Hd, device=dev, generator=gen) / math.sqrt(Hd)
        b2 = 0.1 * torch.randn(C, device=dev, generator=gen)
        shape = (R, C, "v1 pre-norm" if pre else "v2 post-norm")
        compare(mlp_block(x32, lw, lb, w1, b1, w2, b2, pre_norm=pre),
                mlp_block_plain(x32, lw, lb, w1, b1, w2, b2, pre_norm=pre),
                torch.float32, f"{tag} f32 {shape}")
        x, w1h, w2h = x32.bfloat16(), w1.bfloat16(), w2.bfloat16()
        ref = mlp_block_plain(x.float(), lw, lb, w1h.float(), b1, w2h.float(), b2, pre_norm=pre)
        err = compare(mlp_block(x, lw, lb, w1h, b1, w2h, b2, pre_norm=pre), ref,
                      torch.bfloat16, f"{tag} bf16 {shape}")
        max_err = max(max_err, err)
        ms = time_ms(lambda: mlp_block(x, lw, lb, w1h, b1, w2h, b2, pre_norm=pre))
        # a train forward's K2 also writes fc1's pre-activation h1 for K2b
        train_ms = time_ms(lambda: mlp_block.forward_only(x, lw, lb, w1h, b1, w2h, b2,
                                                          pre_norm=pre, keep=True))
        plain_ms = time_ms(lambda: mlp_block_plain(x, lw, lb, w1h, b1, w2h, b2, pre_norm=pre))
        cublas_ms = time_ms(lambda: F.linear(F.linear(x, w1h), w2h))
        # the products alone, fc1 (GELU) then fc2 (+ b2, + x on V1), at each width
        picks = (pick_tile(R, Hd, C, sms), pick_tile(R, C, Hd, sms))
        hid = product_bf16(x, w1h, b1, epi=1, tile=picks[0])
        by_width = []
        for w in TILE_WIDTHS:
            fc1 = time_ms(lambda: product_bf16(x, w1h, b1, epi=1, tile=w))
            fc2 = time_ms(lambda: product_bf16(hid, w2h, b2, epi=2 if pre else 0, tile=w,
                                               resid=x if pre else None))
            by_width.append((w, fc1, fc2))
        products_ms = (next(t for w, t, _ in by_width if w == picks[0])
                       + next(t for w, _, t in by_width if w == picks[1]))
        nbytes = 2 * R * C * 2 + 2 * C * Hd * 2 + (Hd + 3 * C) * 4
        ops = 4 * R * C * Hd
        b_ms, b_by = bound(nbytes, ops, BF16_FLOPS)
        log(f"[{tag}] rows,C={shape} x{calls}/fwd  bf16 {ms:.4f} ms (train, h1 kept: "
            f"{train_ms:.4f} ms)  plain {plain_ms:.4f} ms  "
            f"bound {b_ms:.4f} ms ({b_by})  err {err:.2e}  tiles fc1 {picks[0]} fc2 "
            f"{picks[1]}: products alone {products_ms:.4f} ms "
            f"({ops / products_ms / 1e9:.1f} TFLOP/s)  cuBLAS products only (no GELU, LN, "
            f"residual) {cublas_ms:.4f} ms")
        log(f"[{tag}]   products alone by tile width, ms (busiest SM's tiles): " + "; ".join(
            f"{w}: fc1 {f1:.4f} ({busiest_sm_tiles(R, Hd, w, sms)}) fc2 {f2:.4f} "
            f"({busiest_sm_tiles(R, C, w, sms)})" for w, f1, f2 in by_width))
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                         ("products_ms", products_ms), ("cublas_ms", cublas_ms),
                         ("train_ms", train_ms), ("bytes", nbytes), ("ops", ops)):
            tot[key] += calls * val
        del x32, x, hid, ref
    log(f"[{tag}] per forward: {tot['ms']:.3f} ms (a train forward, h1 kept: {tot['train_ms']:.3f} "
        f"ms), of which products alone {tot['products_ms']:.3f} ms; plain {tot['plain_ms']:.3f} "
        f"ms; cuBLAS products only {tot['cublas_ms']:.3f} ms; bound {tot['bound_ms']:.3f} ms")
    return max_err, tot


def k3_shapes():
    """(geom, calls per forward) for every chain geometry of the chain path."""
    from avmoe_tpu_torch.config import AVEConfig
    from avmoe_tpu_torch.moe.injection import chain_calls

    cfg = AVEConfig()
    rows = {}
    for c in chain_calls(cfg.swin, cfg.htsat, cfg.injection):
        rows[c.geom] = rows.get(c.geom, 0) + 1
    return list(rows.items())


def _chain_blocks(geom, gen):
    """Seeded SwinBlocks of one chain geometry on the card (biases and norms noised)."""
    from avmoe_tpu_torch.models.ave import init_parameters
    from avmoe_tpu_torch.ops.swin import SwinBlock

    blocks = torch.nn.ModuleList(
        SwinBlock(geom.C, (geom.H, geom.W), geom.num_heads, geom.window, shift,
                  version=geom.version, mlp_ratio=geom.mlp_hidden / geom.C,
                  pretrained_window=geom.window if geom.version == "v2" else 0)
        for shift in geom.shifts).to("cuda")
    init_parameters(blocks, gen)
    with torch.no_grad():
        for p in blocks.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen, device="cuda"))
    return list(blocks)


def k3_cost(geom, G: int):
    """(bytes, operations) of one chain call: the stream read and written
    once in bf16, the weights its part reads (bf16) with the float32 bias
    table and, when shifted, mask; fused_block.py:289-302's count."""
    C, N, K, Hd, nH = geom.C, geom.N, geom.K, geom.mlp_hidden, geom.num_heads
    full = geom.part == "full"
    ops = 2 * G * N * (4 * C * C + (2 * C * Hd if full else 0)) * K + 4 * G * N * N * C * K
    w = (4 * C * C + 4 * C + (2 * C * Hd + Hd + 3 * C if full else 0)) * 2 + nH * N * N * 4
    nbytes = 2 * G * N * C * 2 + K * w + (geom.nW * N * N * 4 if geom.shifts[0] else 0)
    return nbytes, ops


def phase_k3(gen, shapes=None, tag: str = "K3", frames: int = BATCH * 10):
    """K3 against its plain version at every (geometry, calls) of `shapes`
    (the AVE chain path's by default) over `frames` frames, float32 and
    bf16, with times; the largest bf16 |d| and the times summed over the
    calls."""
    from avmoe_tpu_torch.kernels.block_chain import block_chain, block_chain_plain, stack_chain
    from avmoe_tpu_torch.ops.swin import partition_windows

    max_err = 0.0
    failed = []
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0.0, ops=0.0, rel_by_K={})
    for geom, calls in k3_shapes() if shapes is None else shapes:
        G = frames * geom.nW
        blocks = _chain_blocks(geom, gen)
        x = torch.randn(frames, geom.H * geom.W, geom.C, device="cuda", generator=gen)
        xw = partition_windows(x, geom.H, geom.W, geom.window, geom.shifts[0]).contiguous()
        shape = (geom.version, geom.part, f"K={geom.K}", f"G={G}", f"N={geom.N}",
                 f"C={geom.C}", f"shift={geom.shifts[0]}")
        ops32, _ = stack_chain(blocks, geom.part, torch.float32)
        ref32 = block_chain_plain(xw, ops32, geom)
        d32 = (block_chain.windows(xw, ops32, geom) - ref32).abs()
        if not bool((d32 <= 1e-4 + 1e-4 * ref32.abs()).all()):
            failed.append(f"{tag} f32 {shape}: max |d| {d32.max().item():.3e}")
        ops, _ = stack_chain(blocks, geom.part, torch.bfloat16)
        x16 = xw.bfloat16()
        ref = block_chain_plain(x16.float(), {k: v.float() for k, v in ops.items()}, geom)
        out = block_chain.windows(x16, ops, geom)
        d = (out.float() - ref).abs()
        rel = (d / (1.0 + ref.abs())).max().item()
        # the plain version in bf16 rounds where the Pallas body rounds
        rel_plain = ((block_chain_plain(x16, ops, geom).float() - ref).abs()
                     / (1.0 + ref.abs())).max().item()
        err = d.max().item()
        tol = k3_bf16_budget(geom, rel_plain)
        if not (rel <= tol and math.isfinite(err)):
            failed.append(f"{tag} bf16 {shape}: max |d| / (1 + |ref|) {rel:.3e} > {tol:.3e}")
        max_err = max(max_err, err)
        tot["rel_by_K"][geom.K] = max(tot["rel_by_K"].get(geom.K, 0.0), rel)
        ms = time_ms(lambda: block_chain.windows(x16, ops, geom))
        plain_ms = time_ms(lambda: block_chain_plain(x16, ops, geom))
        nbytes, nops = k3_cost(geom, G)
        b_ms, b_by = bound(nbytes, nops, BF16_FLOPS)
        log(f"[{tag}] {' '.join(shape)} x{calls}/fwd  bf16 {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"bound {b_ms:.4f} ms ({b_by})  max |d| {err:.2e}, /(1+|ref|) {rel:.2e} "
            f"(plain bf16 {rel_plain:.2e}, bound {tol:.2e}), f32 {d32.max().item():.2e}")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                         ("bytes", nbytes), ("ops", nops)):
            tot[key] += calls * val
        del blocks, ops, ops32, x, xw, x16, ref, ref32, out, d, d32
        torch.cuda.empty_cache()
    check(not failed, "K3 kernel disagrees with its plain version:\n" + "\n".join(failed))
    return max_err, tot


def _nonzero_gates_(model, seed: int) -> None:
    """Adapter gates and gate_av (the cross-modal and the bmm experts'), the
    AVVP class tokens (all zero at init) and BN running stats made
    non-trivial."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf not in ("gate", "gate_av", "audio_token", "visual_token", "running_mean",
                            "running_var"):
                continue
            noise = torch.randn(t.shape, generator=g).to(t.device)
            if leaf in ("gate", "gate_av"):
                t.copy_(0.5 + 0.2 * noise)
            elif leaf in ("audio_token", "visual_token"):
                t.copy_(noise)
            elif leaf == "running_var" and "bn0" not in name:
                t.copy_(0.5 + 0.2 * noise.abs())
            elif leaf == "running_mean" and "bn0" not in name:
                t.copy_(0.1 * noise)
            elif leaf == "running_mean":     # bn0: per-mel-bin stats of dB values
                t.copy_(-30.0 + 5.0 * noise)
            elif leaf == "running_var":
                t.copy_(200.0 + 50.0 * noise.abs())


def _inputs(cfg, clips: int, seed: int, device):
    rng = np.random.RandomState(seed)
    wave = rng.randn(clips, cfg.num_segments, cfg.audio_len).astype(np.float32) * 0.1
    imgs = rng.rand(clips, cfg.num_segments, cfg.swin.img_size, cfg.swin.img_size,
                    3).astype(np.float32)
    return torch.from_numpy(wave).to(device), torch.from_numpy(imgs).to(device)


def phase_tiny():
    from avmoe_tpu_torch.config import tiny_ave_config
    from avmoe_tpu_torch.kernels.block_chain import block_chain
    from avmoe_tpu_torch.models.ave import AVEModel

    cfg = tiny_ave_config()
    cpu = AVEModel(cfg, device="cpu", seed=0)
    _nonzero_gates_(cpu, 1)
    wave, imgs = _inputs(cfg, 2, 2, "cpu")
    for chains in (False, True):
        label = "chain path" if chains else "default path"
        cpu.encoder.block_chains = chains
        ref = cpu(wave, imgs)
        gpu = AVEModel(cfg, device="cuda", seed=None, block_chains=chains)
        gpu.load_state_dict(cpu.state_dict())
        block_chain.launches = 0
        out = gpu(wave.cuda(), imgs.cuda())
        torch.cuda.synchronize()
        check((block_chain.launches > 0) == chains, f"tiny {label}: K3 launches "
              f"{block_chain.launches}")
        worst = 0.0
        for key in ("is_event_logits", "event_logits", "av_score"):
            a, b = out[key].cpu(), ref[key]
            worst = max(worst, (a - b).abs().max().item())
            check(torch.allclose(a, b, rtol=1e-3, atol=1e-4), f"tiny {label} {key}: card vs "
                  f"CPU max |d| {(a - b).abs().max().item():.3e}")
        for key in ("audio_p1", "audio_p2", "video_p1", "video_p2"):
            a, b = out["telemetry"][key].cpu(), ref["telemetry"][key]
            check(torch.allclose(a, b, rtol=1e-3, atol=1e-4),
                  f"tiny {label} gating {key}: card vs CPU")
        log(f"[tiny] AVE fp32 {label}, card (kernels) vs CPU (plain): max |d| {worst:.3e} "
            f"(rtol 1e-3, atol 1e-4)")


def _logits(out) -> torch.Tensor:
    return torch.cat([out["is_event_logits"].float().flatten(),
                      out["event_logits"].float().flatten()])


def _counters():
    from avmoe_tpu_torch.kernels.block_chain import block_chain
    from avmoe_tpu_torch.kernels.mlp_block import mlp_block
    from avmoe_tpu_torch.kernels.window_attention import window_attention

    return {"K1": window_attention, "K2": mlp_block, "K3": block_chain}


def _drive(model, label: str, want, wave, imgs):
    """Batch BATCH and 1 through `model`, each with the kernels' counts set to
    0 just before and read just after: launches per forward as the injection
    plan gives them, output shapes, finiteness, gating sums."""
    counters = _counters()
    outs = {}
    for clips in (BATCH, 1):
        for c in counters.values():
            c.launches = 0
        out = model(wave[:clips], imgs[:clips])
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        check(got == want, f"{label} batch {clips}: launches per forward {got}, want {want}")
        check(tuple(out["is_event_logits"].shape) == (clips, 10)
              and tuple(out["event_logits"].shape) == (clips, 28)
              and tuple(out["av_score"].shape) == (clips, 28), f"{label}: output shapes")
        for key in ("is_event_logits", "event_logits", "av_score"):
            check(bool(torch.isfinite(out[key]).all()), f"{label}: {key} not finite")
        for key in ("audio_p1", "audio_p2", "video_p1", "video_p2"):
            p = out["telemetry"][key]
            check(tuple(p.shape) == (8, clips * 10, 2), f"{label}: {key} shape {tuple(p.shape)}")
            check(bool(((p.sum(-1) - 1.0).abs() <= 1e-3).all()),
                  f"{label}: {key} probs do not sum to 1")
        outs[clips] = out
        log(f"[full] {label} batch {clips}: shapes ok, finite, gating sums ok, launches "
            + " ".join(f"{k} {v}" for k, v in got.items()))
    return outs, got


def _times(model, label: str, *inputs, batch1: bool = True) -> float:
    """Batch-4 throughput (2 warm-ups, 5 iterations) and, with `batch1`,
    batch-1 p50 (of 5) of model(*inputs), the inputs batch-first."""
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        model(*inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        model(*inputs)
    torch.cuda.synchronize()
    fwd_s = (time.perf_counter() - t0) / 5
    p50 = ""
    if batch1:
        one = tuple(t[:1] for t in inputs)
        for _ in range(2):
            model(*one)
        lat = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model(*one)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
        p50 = f"; batch-1 p50 {float(np.percentile(lat, 50)) * 1e3:.2f} ms"
    log(f"[time] {label} eval batch {BATCH}: {fwd_s * 1e3:.2f} ms/forward, "
        f"{BATCH / fwd_s:.3f} clips/s{p50}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return fwd_s * 1e3


def phase_full():
    from avmoe_tpu_torch.config import AVEConfig
    from avmoe_tpu_torch.models.ave import AVEModel
    from avmoe_tpu_torch.moe.injection import kernel_launches

    cfg = AVEConfig()
    t0 = time.perf_counter()
    model = AVEModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    _nonzero_gates_(model, 1)
    chain = AVEModel(cfg, dtype=torch.bfloat16, device="cuda", seed=None, block_chains=True)
    chain.load_state_dict(model.state_dict())
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[full] AVEConfig() bf16 built in {time.perf_counter() - t0:.1f} s (both paths), "
        f"{n_params} parameters")
    wave, imgs = _inputs(cfg, BATCH, 3, "cuda")
    paths = {"default path": model, "chain path": chain}
    outs, launches = {}, {}
    for label, m in paths.items():
        want = kernel_launches(cfg.swin, cfg.htsat, cfg.injection, m.encoder.block_chains)
        outs[label], launches[label] = _drive(m, label, want, wave, imgs)

    f32 = AVEModel(cfg, dtype=torch.float32, device="cuda", seed=None)
    f32.load_state_dict(model.state_dict())
    for label, m in paths.items():
        f32.encoder.block_chains = m.encoder.block_chains
        ref = f32(wave, imgs)
        torch.cuda.synchronize()
        cos = F.cosine_similarity(_logits(outs[label][BATCH]), _logits(ref), dim=0).item()
        check(cos >= 0.99, f"{label}: bf16 vs fp32 logits cosine {cos:.5f} < 0.99")
        log(f"[full] {label}: bf16 vs fp32 logits cosine {cos:.6f} (>= 0.99)")
    del f32, ref
    torch.cuda.empty_cache()
    cos = F.cosine_similarity(_logits(outs["chain path"][BATCH]),
                              _logits(outs["default path"][BATCH]), dim=0).item()
    check(cos >= 0.99, f"bf16 chain path vs default path logits cosine {cos:.5f} < 0.99")
    log(f"[full] bf16 chain path vs default path logits cosine {cos:.6f} (>= 0.99)")

    fwd_ms, profs = {}, {}
    for label, m in paths.items():
        fwd_ms[label] = _times(m, label, wave, imgs)
        profs[label] = phase_profile(label, lambda m=m: m(wave, imgs), fwd_ms[label])
    return launches, fwd_ms, profs, model


def _host_summary(label: str, prof, what: str) -> None:
    """What the host does per run in a profiled window: its CUDA runtime
    calls by name (kernel launches, copies, synchronizations) and the
    PyTorch ops with the most self CPU time (the profiler's own host work
    inflates both)."""
    cpu = [(e.key, e.count, e.self_cpu_time_total / 1e3)
           for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    runtime = sorted((r for r in cpu if r[0].startswith("cu")), key=lambda r: -r[2])
    ops = sorted((r for r in cpu if not r[0].startswith("cu")), key=lambda r: -r[2])
    log(f"[host] {label}: per {what}, self CPU {sum(r[2] for r in cpu):.2f} ms, of which CUDA "
        f"runtime calls {sum(r[2] for r in runtime):.2f} ms: "
        + ", ".join(f"{k} x{n:.0f} {ms:.2f} ms" for k, n, ms in runtime[:8]))
    log(f"[host] {label}: ops by self CPU ms: "
        + ", ".join(f"{k} x{n:.0f} {ms:.2f}" for k, n, ms in ops[:14]))


def _device_ms_by_name(prof) -> dict:
    """{kernel name: device ms} of a profiler's window: device-side kernel
    and memcpy events only (the host ops that launched them carry the same
    device time again, and so do the device spans of annotations, such as
    the optimizer's step)."""
    by_name = {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    return by_name


# The windows phase_profile traces: each cost 1 to 40 s of host time with
# the host's ops traced, most of it the profiler's processing of the trace
# as it stops (a window of ~10,800 small kernels: 16.3 s with the host's
# ops, 2.5 s without, device busy 27.9 / 27.6 ms; so the host's ops are
# traced only in HOST_SUMMARY's windows), and device busy repeats within
# 2.5% from run to run. Kept: AVE's eval (default path) and train step, both again
# on the fused combine, a train step of AVVP, AVQA and AVS (S4's; the
# legacy models' are not profiled: MMIL_Net v1's busy read 322.51 and
# 321.73 ms in two runs), and the two small windows of AVQA's
# negative pass and TPAVI. The host's side (`_host_summary`) is read in
# AVE's two materialized windows.
PROFILED = ("default path", "train step", "fused eval", "fused train step",
            "AVVP train step", "AVQA negative pass (default path)", "AVQA train step",
            "AVS TPAVI alone (4 stages)", "AVS S4 train step")
HOST_SUMMARY = ("default path", "train step")


def phase_profile(label: str, run, fwd_ms: Optional[float], what: str = "forward"):
    """Device time per `run()` (a forward or a train step) by kernel
    (torch.profiler), and the share of the wall time in which the device was
    idle: of `fwd_ms`, the unprofiled wall time of the same work (None: no
    such wall; the device-side time of work that keeps the device busy is
    no bound on the profiler's own kernel timings, ~1% longer), and of the
    profiled window, whose wall time also holds the profiler's own host work.
    Only the windows in `PROFILED` are traced (the others return three
    Nones). One run is profiled, after a traced warm-up run whose events are
    dropped: processing the trace costs the host ~15 s for each ~10,000
    kernel launches where the host's ops are traced (HOST_SUMMARY's windows
    only; ~2.5 s without them), device busy repeats within a few percent
    from run to run, and without the warm-up the kernels just after the profiler starts
    can go unrecorded (TPAVI alone read 1.67 of ~11 ms busy).
    Returns (device-busy ms, idle share of fwd_ms or None, idle share of the
    profiled window), all None where the profiler saw no kernels. Logs what the host
    spent the window on (_host_summary) too."""
    from torch.profiler import ProfilerActivity, profile, schedule

    if label not in PROFILED:
        log(f"[profile] {label}: not profiled (chip_smoke.PROFILED)")
        return None, None, None
    # the host's ops are traced only where they are read (HOST_SUMMARY): their
    # events, not the kernels', make most of the trace's read-back
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if label in HOST_SUMMARY else [])
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1),
                 acc_events=True) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.step()
    by_name = _device_ms_by_name(prof)
    busy = sum(by_name.values())
    if busy == 0:
        log(f"[profile] {label}: device time not measured (the profiler saw no CUDA kernels)")
        return None, None, None
    # one stream, synchronized at both ends of each window: its kernels fit in it
    for w in (wall,) if fwd_ms is None else (wall, fwd_ms):
        check(busy <= w, f"{label}: device busy {busy:.3f} ms > wall {w:.3f} ms")
    # first matching group wins
    rules = (("K3 block_chain", ("block_chain_kernel",)),
             ("K1b window_attention_bwd", ("window_attention_bwd",)),
             ("K1 window_attention", ("window_attention_",)),
             ("K2 + K2b mlp_block", ("mlp_gemm_", "mlp_rows", "ln_bwd_rows")),
             ("library GEMM", ("gemm", "xmma", "cutlass", "sm90_")),
             ("softmax/reductions", ("softmax", "reduce")),
             ("copies/casts", ("copy", "Memcpy", "Memset", "cat")),
             ("elementwise", ("elementwise",)))
    groups = {group: 0.0 for group, _ in rules}
    groups["other"] = 0.0
    for name, ms in by_name.items():
        group = next((g for g, keys in rules if any(k in name for k in keys)), "other")
        groups[group] += ms
    idle = None if fwd_ms is None else 1.0 - busy / fwd_ms
    of_fwd = "" if fwd_ms is None else f"of {fwd_ms:.2f} ms wall "
    log(f"[profile] {label} batch {BATCH}: device busy {busy:.2f} ms {of_fwd}per {what} "
        + ("" if idle is None else f"(idle share {idle:.3f}; ")
        + f"{'(' if idle is None else ''}of the profiled window's {wall:.2f} ms "
        f"{1.0 - busy / wall:.3f}); " + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items()))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    for name, ms in top:
        log(f"[profile] {label}  {ms:8.3f} ms  {100 * ms / busy:5.1f}%  {name[:100]}")
    if label in HOST_SUMMARY:
        _host_summary(label, prof, what)
    return busy, idle, 1.0 - busy / wall


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def _grads(fn, inputs, dout):
    """fn's output and the gradients of its inputs for the output gradient dout."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, dout)


def _backward_ms(fn, inputs, dout) -> float:
    """Time of the backward alone of fn (its forward run once, its graph kept)."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return time_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True))


def phase_k1b(gen, frames: int = BATCH * 10, tag: str = "K1b"):
    """K1b against the plain version's autograd at every K1b shape of a train
    step over `frames` frames, float32 and bf16, with times."""
    from avmoe_tpu_torch.kernels.window_attention import (
        window_attention, window_attention_bwd, window_attention_plain)

    dev = "cuda"
    max_err = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, bytes=0.0, ops=0.0,
               max_rel_err=0.0)
    for BW, H, N, D, nW, calls in k1b_shapes(frames):
        q32 = torch.randn(BW, H, N, D, device=dev, generator=gen) * 0.3
        k32 = torch.randn(BW, H, N, D, device=dev, generator=gen) * 0.3
        v32 = torch.randn(BW, H, N, D, device=dev, generator=gen)
        bias = torch.randn(nW, H, N, N, device=dev, generator=gen)
        do32 = torch.randn(BW, H, N, D, device=dev, generator=gen)
        shape = (BW, H, N, D, nW)
        kern = lambda q, k, v: window_attention(q, k, v, bias)
        plain = lambda q, k, v: window_attention_plain(q, k, v, bias)
        _, got = _grads(kern, (q32, k32, v32), do32)
        _, ref = _grads(plain, (q32, k32, v32), do32)
        for name, a, b in zip("qkv", got, ref):
            compare(a, b, torch.float32, f"{tag} f32 {shape} d{name}")
        q, k, v, do = (t.bfloat16() for t in (q32, k32, v32, do32))
        _, got = _grads(kern, (q, k, v), do)
        _, ref = _grads(plain, (q.float(), k.float(), v.float()), do.float())
        err = max(compare(a, b, torch.bfloat16, f"{tag} bf16 {shape} d{name}")
                  for name, a, b in zip("qkv", got, ref))
        rel = max(((a.float() - b).abs() / (1 + b.abs())).max().item() for a, b in zip(got, ref))
        max_err, tot["max_rel_err"] = max(max_err, err), max(tot["max_rel_err"], rel)
        out = window_attention.forward_only(q, k, v, bias)
        ms = time_ms(lambda: window_attention_bwd(q, k, v, bias, out, do))
        plain_ms = _backward_ms(plain, (q, k, v), do)
        mask = bias.repeat(BW // nW, 1, 1, 1).bfloat16()
        lib_ms = _backward_ms(lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, attn_mask=mask, scale=1.0), (q, k, v), do)
        # q, k, v, out, dO read and dq, dk, dv written in bf16, the bias in
        # float32; five N x N x D products (S recomputed, dP, dv, dq, dk)
        nbytes = 8 * BW * H * N * D * 2 + nW * H * N * N * 4
        ops = 10 * BW * H * N * N * D
        b_ms, b_by = bound(nbytes, ops, BF16_FLOPS)
        log(f"[{tag}] BW,H,N,D,nW={shape} x{calls}/step  bf16 {ms:.4f} ms  plain autograd "
            f"{plain_ms:.4f} ms  sdpa backward {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  "
            f"{ops / ms * 1e-9:.1f} TFLOP/s  {b_ms / ms:.3f} of the bound  err {err:.2e} "
            f"(|d| / (1 + |ref|) {rel:.2e})")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                         ("library_ms", lib_ms), ("bytes", nbytes), ("ops", ops)):
            tot[key] += calls * val
        del q32, k32, v32, bias, do32, q, k, v, do, got, ref, out, mask
        torch.cuda.empty_cache()
    log(f"[{tag}] per train step: {tot['ms']:.3f} ms; plain autograd {tot['plain_ms']:.3f} ms; "
        f"sdpa backward {tot['library_ms']:.3f} ms; bound {tot['bound_ms']:.3f} ms; "
        f"{tot['ops'] / tot['ms'] * 1e-9:.1f} TFLOP/s, {tot['bound_ms'] / tot['ms']:.3f} of the "
        f"bound; bf16 error up to {max_err:.3e} (|d| / (1 + |ref|) up to "
        f"{tot['max_rel_err']:.3e})")
    return max_err, tot


def _mlp_weights(C: int, gen):
    dev = "cuda"
    Hd = 4 * C
    return (1.0 + 0.1 * torch.randn(C, device=dev, generator=gen),
            0.1 * torch.randn(C, device=dev, generator=gen),
            torch.randn(Hd, C, device=dev, generator=gen) / math.sqrt(C),
            0.1 * torch.randn(Hd, device=dev, generator=gen),
            torch.randn(C, Hd, device=dev, generator=gen) / math.sqrt(Hd),
            0.1 * torch.randn(C, device=dev, generator=gen))


def phase_k2b(gen, frames: int = BATCH * 10, tag: str = "K2b"):
    """K2 and K2b against the plain version and its autograd at every K2b
    shape of a train step over `frames` frames, both norms, with and without
    the DropPath scale, float32 and bf16, with times."""
    from avmoe_tpu_torch.kernels import mlp_block as mb

    dev = "cuda"
    sms = mb.sm_count(torch.cuda.current_device())
    max_err = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, products_ms=0.0, cublas_ms=0.0,
               bytes=0.0, ops=0.0)
    # DropPath at rate 0.1 over the frames, with a zero in it for sure
    scale = (torch.rand(frames, device=dev, generator=gen) >= 0.1).float() / 0.9
    scale[0] = 0.0
    for R, C, pre, calls in k2b_shapes(frames):
        Hd, L = 4 * C, R // frames
        lw, lb, w1, b1, w2, b2 = _mlp_weights(C, gen)
        x32 = torch.randn(frames, L, C, device=dev, generator=gen)
        dy32 = torch.randn(frames, L, C, device=dev, generator=gen)
        shape_err = 0.0
        for norm in (pre, not pre):
            for sc in (None, scale):
                case = (R, C, "v1 pre-norm" if norm else "v2 post-norm",
                        "scaled" if sc is not None else "unscaled")
                kern = lambda t, W1, W2: mb.mlp_block(t, lw, lb, W1, b1, W2, b2, pre_norm=norm,
                                                      scale=sc)
                plain = lambda t, W1, W2: mb.mlp_block_plain(t, lw, lb, W1, b1, W2, b2,
                                                             pre_norm=norm, scale=sc)
                out, (dx,) = _grads(lambda t: kern(t, w1, w2), (x32,), dy32)
                ref, (dx_ref,) = _grads(lambda t: plain(t, w1, w2), (x32,), dy32)
                compare(out, ref, torch.float32, f"{tag} (K2) f32 {case}")
                compare(dx, dx_ref, torch.float32, f"{tag} f32 {case}")
                x, dy, W1, W2 = x32.bfloat16(), dy32.bfloat16(), w1.bfloat16(), w2.bfloat16()
                out, (dx,) = _grads(lambda t: kern(t, W1, W2), (x,), dy)
                ref, (dx_ref,) = _grads(lambda t: plain(t, W1.float(), W2.float()),
                                        (x.float(),), dy.float())
                compare(out, ref, torch.bfloat16, f"{tag} (K2) bf16 {case}")
                err = compare(dx, dx_ref, torch.bfloat16, f"{tag} bf16 {case}")
                if norm == pre:
                    shape_err = max(shape_err, err)
        # times at the shape's own norm with the DropPath scale, as in a train step
        x, dy, W1, W2 = x32.bfloat16(), dy32.bfloat16(), w1.bfloat16(), w2.bfloat16()
        W1t, W2t = W1.t().contiguous(), W2.t().contiguous()
        _, h1, f = mb.mlp_block.forward_only(x, lw, lb, W1, b1, W2, b2, pre_norm=pre,
                                             scale=scale, keep=True)
        src = x if pre else f
        ms = time_ms(lambda: mb.mlp_block_bwd(dy, h1, src, lw, W1t, W2t, pre_norm=pre,
                                              scale=scale))
        plain_ms = _backward_ms(lambda t: mb.mlp_block_plain(
            t, lw, lb, W1, b1, W2, b2, pre_norm=pre, scale=scale), (x,), dy)
        # K2b's two products alone on the wgmma kernel (d_h1 from dy, or from
        # d_h2 = dy on V2, the LN row pass left out) at the picked widths and
        # at each width, and cuBLAS's bf16 products of the same shapes
        picks = (mb.pick_wgmma_tile(R, Hd, C, sms, gelu=True),
                 mb.pick_wgmma_tile(R, C, Hd, sms))
        dy2, h1_2 = dy.reshape(R, C), h1.reshape(R, Hd)
        sc1 = scale if pre else None
        epi2, aux2 = (mb.EPI_PLAIN, None) if pre else (mb.EPI_ADD, dy2)
        d_h1 = mb.product_wgmma(dy2, W2t, epi=mb.EPI_GELU_GRAD, tile=picks[0], aux=h1_2,
                                scale=sc1)
        by_width = []
        for w in mb.WGMMA_WIDTHS:
            p1 = time_ms(lambda: mb.product_wgmma(dy2, W2t, epi=mb.EPI_GELU_GRAD, tile=w,
                                                  aux=h1_2, scale=sc1))
            p2 = time_ms(lambda: mb.product_wgmma(d_h1, W1t, epi=epi2, tile=w, aux=aux2))
            by_width.append((w, p1, p2))
        products_ms = (next(t for w, t, _ in by_width if w == picks[0])
                       + next(t for w, _, t in by_width if w == picks[1]))
        cublas_ms = time_ms(lambda: F.linear(dy2, W2t)) + time_ms(lambda: F.linear(d_h1, W1t))
        # dy, x or f read and dx written, h1 read, in bf16; w1t and w2t; the
        # float32 norm weight and scale; two products (d_h1 not counted: a
        # fused kernel would not move it)
        nbytes = 3 * R * C * 2 + R * Hd * 2 + 2 * C * Hd * 2 + (C + frames) * 4
        ops = 4 * R * C * Hd
        b_ms, b_by = bound(nbytes, ops, BF16_FLOPS)
        log(f"[{tag}] rows,C={(R, C, 'v1' if pre else 'v2')} x{calls}/step  bf16 {ms:.4f} ms "
            f"({ops / ms / 1e9:.1f} TFLOP/s)  plain autograd {plain_ms:.4f} ms  bound {b_ms:.4f} "
            f"ms ({b_by})  err {shape_err:.2e}  widths {picks[0]} / {picks[1]}: its 2 "
            f"products alone {products_ms:.4f} ms "
            f"({ops / products_ms / 1e9:.1f} TFLOP/s), cuBLAS's {cublas_ms:.4f} ms")
        log(f"[{tag}]   products alone by tile width, ms (busiest SM's tiles): " + "; ".join(
            f"{w}: d_h1 {a:.4f} ({mb.busiest_sm_tiles(R, Hd, w, sms)}) dx {b:.4f} "
            f"({mb.busiest_sm_tiles(R, C, w, sms)})" for w, a, b in by_width))
        max_err = max(max_err, shape_err)
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                         ("products_ms", products_ms), ("cublas_ms", cublas_ms),
                         ("bytes", nbytes), ("ops", ops)):
            tot[key] += calls * val
        del x32, dy32, x, dy, W1, W2, W1t, W2t, h1, f, src, d_h1, out, ref, dx, dx_ref
        torch.cuda.empty_cache()
    log(f"[{tag}] per train step: {tot['ms']:.3f} ms ({tot['ops'] / tot['ms'] * 1e-9:.1f} "
        f"TFLOP/s), of which products alone {tot['products_ms']:.3f} ms "
        f"({tot['ops'] / tot['products_ms'] * 1e-9:.1f} TFLOP/s, "
        f"{tot['products_ms'] / tot['cublas_ms']:.3f} x cuBLAS's); plain autograd "
        f"{tot['plain_ms']:.3f} ms; cuBLAS products only {tot['cublas_ms']:.3f} ms; bound "
        f"{tot['bound_ms']:.3f} ms")
    return max_err, tot


def _param_err(a, b, dtype, terms: int, what: str) -> float:
    """A parameter gradient summed over `terms` frames or rows, kernel (a)
    against the float32 plain autograd (b): float32 |d| <= 1e-5 sqrt(terms)
    + 1e-4 |ref|; bf16 max |d| <= 2e-2 (1 + max |ref|). Returns max |d|."""
    check(a.dtype == torch.float32 and a.shape == b.shape,
          f"{what}: {a.dtype} {tuple(a.shape)}, want float32 {tuple(b.shape)}")
    d = (a - b).abs()
    err = d.max().item()
    if dtype == torch.float32:
        ok = bool((d <= 1e-5 * math.sqrt(terms) + 1e-4 * b.abs()).all())
    else:
        ok = err <= 2e-2 * (1.0 + b.abs().max().item())
    check(ok and math.isfinite(err), f"{what}: kernel disagrees with its plain version "
                                     f"(max |d| {err:.3e}, max |ref| {b.abs().max().item():.3e})")
    return err


def s4_k1b_bias_shapes(frames: int):
    """(BW, H, N, D, nW, launches per S4 step) where K1b gives dbias: every
    HTS-AT K1 call of the S4 step (HTS-AT trains), and Swin-V2-L stage 1's
    shifted shape, on no path (0 launches), for the CPB MLP's bias."""
    htsat = [s for s in k1_shapes(frames) if s[2] == 64]
    return htsat + [(frames * 4, 12, 144, 32, 4, 0)]


def phase_k1b_bias(gen, frames: int = BATCH * 5, tag: str = "K1b dbias"):
    """K1b's bias gradient against the plain version's autograd at the S4
    step's HTS-AT shapes (every stage, shifted and unshifted) and a Swin-V2
    shape, float32 (|d| <= 1e-5 sqrt(BW / nW) + 1e-4 |ref|) and bf16 (max |d|
    <= 2e-2 (1 + max |ref|) against the float32 plain autograd of the same
    bf16 inputs), the input gradients as phase_k1b holds them; two calls'
    dbias bit-identical; K1b's time with and without dbias, the plain
    autograd's, SDPA's backward with a mask that needs a gradient, the
    bound. Returns (max |d| bf16, totals per S4 step)."""
    from avmoe_tpu_torch.kernels.window_attention import (
        window_attention, window_attention_bwd, window_attention_plain)

    dev = "cuda"
    tot = dict(ms=0.0, frozen_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, bytes=0.0,
               ops=0.0, f32_err=0.0, launches=0)
    max_err = 0.0
    for BW, H, N, D, nW, calls in s4_k1b_bias_shapes(frames):
        q32 = torch.randn(BW, H, N, D, device=dev, generator=gen) * 0.3
        k32 = torch.randn(BW, H, N, D, device=dev, generator=gen) * 0.3
        v32 = torch.randn(BW, H, N, D, device=dev, generator=gen)
        bias = torch.randn(nW, H, N, N, device=dev, generator=gen)
        if nW > 1:
            bias[1:, :, : N // 2, N // 2:] -= 100.0     # shift-mask entries
        do32 = torch.randn(BW, H, N, D, device=dev, generator=gen)
        shape, frames_per_window = (BW, H, N, D, nW), BW // nW
        _, got = _grads(window_attention, (q32, k32, v32, bias), do32)
        _, ref = _grads(window_attention_plain, (q32, k32, v32, bias), do32)
        for name, a, b in zip("qkv", got, ref):
            compare(a, b, torch.float32, f"{tag} f32 {shape} d{name}")
        f32_err = _param_err(got[3], ref[3], torch.float32, frames_per_window,
                             f"{tag} f32 {shape} dbias")
        q, k, v, do = (t.bfloat16() for t in (q32, k32, v32, do32))
        _, got = _grads(window_attention, (q, k, v, bias), do)
        _, ref = _grads(window_attention_plain, (q.float(), k.float(), v.float(), bias),
                        do.float())
        for name, a, b in zip("qkv", got, ref):
            compare(a, b, torch.bfloat16, f"{tag} bf16 {shape} d{name}")
        err = _param_err(got[3], ref[3], torch.bfloat16, frames_per_window,
                         f"{tag} bf16 {shape} dbias")
        out = window_attention.forward_only(q, k, v, bias)
        for dt, ins, o, g in (("f32", (q32, k32, v32), window_attention.forward_only(
                q32, k32, v32, bias), do32), ("bf16", (q, k, v), out, do)):
            a = window_attention_bwd(*ins, bias, o, g, bias_grad=True)[3]
            b = window_attention_bwd(*ins, bias, o, g, bias_grad=True)[3]
            check(torch.equal(a, b), f"{tag} {dt} {shape}: two calls' dbias differ")
        ms = time_ms(lambda: window_attention_bwd(q, k, v, bias, out, do, bias_grad=True))
        frozen_ms = time_ms(lambda: window_attention_bwd(q, k, v, bias, out, do))
        plain_ms = _backward_ms(window_attention_plain, (q, k, v, bias), do)
        mask = bias.repeat(BW // nW, 1, 1, 1).bfloat16()
        lib_ms = _backward_ms(lambda a, b, c, m: F.scaled_dot_product_attention(
            a, b, c, attn_mask=m, scale=1.0), (q, k, v, mask), do)
        # K1b's bytes and dbias written in float32; its five products and
        # dbias's BW H N N additions
        nbytes = 8 * BW * H * N * D * 2 + 2 * nW * H * N * N * 4
        ops = 10 * BW * H * N * N * D + BW * H * N * N
        b_ms, b_by = bound(nbytes, ops, BF16_FLOPS)
        log(f"[{tag}] BW,H,N,D,nW={shape} x{calls}/S4 step  bf16 with dbias {ms:.4f} ms, "
            f"without {frozen_ms:.4f} ms  plain autograd {plain_ms:.4f} ms  sdpa backward "
            f"(mask grad) {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  dbias err f32 "
            f"{f32_err:.2e}, bf16 {err:.2e}; two calls bit-identical")
        max_err, tot["f32_err"] = max(max_err, err), max(tot["f32_err"], f32_err)
        for key, val in (("ms", ms), ("frozen_ms", frozen_ms), ("plain_ms", plain_ms),
                         ("bound_ms", b_ms), ("library_ms", lib_ms), ("bytes", nbytes),
                         ("ops", ops), ("launches", 1)):
            tot[key] += calls * val
        del q32, k32, v32, bias, do32, q, k, v, do, got, ref, out, mask
        torch.cuda.empty_cache()
    log(f"[{tag}] per S4 step ({tot['launches']} launches with dbias): {tot['ms']:.3f} ms "
        f"with dbias, {tot['frozen_ms']:.3f} ms without; plain autograd {tot['plain_ms']:.3f} ms;"
        f" sdpa backward {tot['library_ms']:.3f} ms; bound {tot['bound_ms']:.3f} ms; dbias "
        f"error up to {tot['f32_err']:.3e} (f32), {max_err:.3e} (bf16)")
    return max_err, tot


def s4_k2b_param_shapes(frames: int):
    """(rows, C, pre_norm, launches per S4 step) where K2b gives the weight
    gradients: every HTS-AT MLP sub-block of the S4 step (V1), and Swin-V2-L
    stage 0's (V2), on no path (0 launches)."""
    return [s for s in k2_shapes(frames) if s[2]] + [(frames * 48 * 48, 192, False, 0)]


def phase_k2b_params(gen, frames: int = BATCH * 5, tag: str = "K2b params"):
    """K2b's six parameter gradients (dW1, db1, dW2, db2, d ln_w, d ln_b)
    and dx against the plain version's autograd at the S4 step's HTS-AT
    shapes (V1) and a Swin-V2 shape (V2), with and without a DropPath scale
    that has zeros, float32 and bf16 (float32 master weights; the bounds of
    phase_k1b_bias, terms = rows); two calls bit-identical; K2b's time with
    them and with dx only, the two float32-output cuBLAS weight products
    alone, the plain autograd's, the bound. Returns (max |d| bf16, totals
    per S4 step)."""
    from avmoe_tpu_torch.kernels import mlp_block as mb

    dev = "cuda"
    tot = dict(ms=0.0, frozen_ms=0.0, products_ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0.0,
               ops=0.0, f32_err=0.0, launches=0)
    max_err = 0.0
    scale = (torch.rand(frames, device=dev, generator=gen) >= 0.1).float() / 0.9
    scale[0] = 0.0
    names = ("dx", "d ln_w", "d ln_b", "dW1", "db1", "dW2", "db2")
    for R, C, pre, calls in s4_k2b_param_shapes(frames):
        Hd, L = 4 * C, R // frames
        params = list(_mlp_weights(C, gen))
        x32 = torch.randn(frames, L, C, device=dev, generator=gen)
        dy32 = torch.randn(frames, L, C, device=dev, generator=gen)
        case_errs = []
        for sc in (None, scale):
            case = (R, C, "v1" if pre else "v2", "scaled" if sc is not None else "unscaled")
            kern = lambda t, *w: mb.mlp_block(t, *w, pre_norm=pre, scale=sc)
            plain = lambda t, *w: mb.mlp_block_plain(t, *w, pre_norm=pre, scale=sc)
            for dt in (torch.float32, torch.bfloat16):
                x, dy = x32.to(dt), dy32.to(dt)
                _, got = _grads(kern, [x] + params, dy)
                rounded = [w.to(dt).float() if i in (2, 4) else w for i, w in enumerate(params)]
                _, ref = _grads(plain, [x.float()] + rounded, dy.float())
                compare(got[0], ref[0], dt, f"{tag} {dt} {case} dx")
                errs = [_param_err(a, b, dt, R, f"{tag} {dt} {case} {n}")
                        for n, a, b in zip(names[1:], got[1:], ref[1:])]
                _, again = _grads(kern, [x] + params, dy)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"{tag} {dt} {case}: two calls' gradients differ")
                if dt == torch.float32:
                    tot["f32_err"] = max(tot["f32_err"], max(errs))
                else:
                    case_errs.append(max(errs))
        # times in bf16 at the step's DropPath scale, from the forward's kept tensors
        x, dy = x32.bfloat16(), dy32.bfloat16()
        lw, lb, w1, b1, w2, b2 = params
        W1, W2 = w1.bfloat16(), w2.bfloat16()
        W1t, W2t = W1.t().contiguous(), W2.t().contiguous()
        _, h1, f, a1, hid = mb.mlp_block.forward_only(x, lw, lb, W1, b1, W2, b2, pre_norm=pre,
                                                      scale=scale, keep=True, acts=True)
        src = x if pre else f
        ms = time_ms(lambda: mb.mlp_block_bwd(dy, h1, src, lw, W1t, W2t, pre_norm=pre,
                                              scale=scale, a1=a1, hid=hid))
        frozen_ms = time_ms(lambda: mb.mlp_block_bwd(dy, h1, src, lw, W1t, W2t, pre_norm=pre,
                                                     scale=scale))
        g2, a2, h2 = dy.reshape(R, C), a1.reshape(R, C), hid.reshape(R, Hd)
        d_h1 = torch.randn(R, Hd, device=dev, generator=gen).bfloat16()
        products_ms = time_ms(lambda: (torch.mm(g2.t(), h2, out_dtype=torch.float32),
                                       torch.mm(d_h1.t(), a2, out_dtype=torch.float32)))
        plain_ms = _backward_ms(lambda t, lw_, lb_, w1_, b1_, w2_, b2_: mb.mlp_block_plain(
            t, lw_, lb_, w1_.to(t.dtype), b1_, w2_.to(t.dtype), b2_, pre_norm=pre, scale=scale),
            [x] + params, dy)
        # dy, src, h1, a1 and gelu(h1) read and dx written in bf16, w1t and
        # w2t, the float32 norm weight and scale, the six float32 gradients;
        # dx's two products and the two weight products
        nbytes = (3 * R * C * 2 + 2 * R * Hd * 2 + R * C * 2 + 2 * C * Hd * 2
                  + (C + frames) * 4 + (2 * C * Hd + Hd + 3 * C) * 4)
        ops = 8 * R * C * Hd
        b_ms, b_by = bound(nbytes, ops, BF16_FLOPS)
        err = max(case_errs)
        log(f"[{tag}] rows,C={(R, C, 'v1' if pre else 'v2')} x{calls}/S4 step  bf16 with the "
            f"weight gradients {ms:.4f} ms, dx only {frozen_ms:.4f} ms, the two cuBLAS weight "
            f"products alone {products_ms:.4f} ms  plain autograd {plain_ms:.4f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})  parameter-gradient err bf16 {err:.2e}; two calls "
            f"bit-identical")
        max_err = max(max_err, err)
        for key, val in (("ms", ms), ("frozen_ms", frozen_ms), ("products_ms", products_ms),
                         ("plain_ms", plain_ms), ("bound_ms", b_ms), ("bytes", nbytes),
                         ("ops", ops), ("launches", 1)):
            tot[key] += calls * val
        del x32, dy32, x, dy, W1, W2, W1t, W2t, h1, f, a1, hid, src, g2, a2, h2, d_h1
        torch.cuda.empty_cache()
    log(f"[{tag}] per S4 step ({tot['launches']} launches with the weight gradients): "
        f"{tot['ms']:.3f} ms, dx only {tot['frozen_ms']:.3f} ms, cuBLAS weight products "
        f"{tot['products_ms']:.3f} ms; plain autograd {tot['plain_ms']:.3f} ms; bound "
        f"{tot['bound_ms']:.3f} ms; error up to {tot['f32_err']:.3e} (f32), {max_err:.3e} (bf16)")
    return max_err, tot


def _train_batches(cfg, clips: int, steps: int, seed: int, device):
    """Seeded AVE batches: waves, frames, one-hot labels (background last) and
    a per-frame mixup λ."""
    rng = np.random.RandomState(seed)
    T = cfg.num_segments
    out = []
    for _ in range(steps):
        labels = np.zeros((clips, T, cfg.num_classes + 1), np.float32)
        cls = rng.randint(0, cfg.num_classes, size=clips)
        for b in range(clips):
            fg = rng.rand(T) < 0.7
            labels[b, fg, cls[b]] = 1.0
            labels[b, ~fg, -1] = 1.0
        wave, imgs = _inputs(cfg, clips, int(rng.randint(1 << 30)), device)
        out.append(dict(wave=wave, images=imgs, labels=torch.from_numpy(labels).to(device),
                        mixup_lambda=torch.from_numpy(
                            rng.uniform(0.3, 0.7, clips * T).astype(np.float32)).to(device)))
    return out


@contextlib.contextmanager
def _deterministic():
    """AVMOE_DETERMINISTIC_TRAIN=1 inside the block (dropout, SpecAugment off)."""
    old = os.environ.get("AVMOE_DETERMINISTIC_TRAIN")
    os.environ["AVMOE_DETERMINISTIC_TRAIN"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("AVMOE_DETERMINISTIC_TRAIN", None)
        else:
            os.environ["AVMOE_DETERMINISTIC_TRAIN"] = old


def _train_counters():
    from avmoe_tpu_torch.kernels.mlp_block import mlp_block, mlp_block_bwd
    from avmoe_tpu_torch.kernels.window_attention import window_attention, window_attention_bwd

    return {"K1": window_attention, "K2": mlp_block, "K1b": window_attention_bwd,
            "K2b": mlp_block_bwd}


def _nudged(batch, keys=("images", "wave")):
    """The batch with `keys` scaled elementwise by 1 + 1e-6 seeded noise."""
    r = np.random.RandomState(1)
    return dict(batch, **{k: batch[k] * (1 + 1e-6 * torch.from_numpy(
        r.randn(*batch[k].shape).astype(np.float32)).to(batch[k].device)) for k in keys})


def _tiny_train_vs_cpu(label: str, cpu, gpu, make_loss_fn, batches, steps: int,
                       frozen_scopes=("swin", "htsat"), nudge: bool = False,
                       fused: bool = False):
    """Train semantics on the card (kernels) against the CPU (plain versions),
    float32, from the same weights, the backbones in `frozen_scopes` frozen:
    one deterministic step's trainable gradients, per leaf (cosine >=
    0.9999), then (unless `steps` is 0) a `steps`-step curve at lr 1e-5
    (AVMOE_DETERMINISTIC_TRAIN=1): losses rtol 1e-3, parameters and running
    stats rtol 1e-3, atol 1e-4. `batches(n, device)` gives n seeded batches.
    At that lr Adam moves a parameter by less than the states' atol, so the
    curve does not see the gradient's direction; the gradient check does.
    With `nudge`, a leaf below 0.9999 passes where 1 - its cosine is within
    4x the CPU's own largest 1 - cosine of a leaf under a 1e-6 relative
    change of the frames and waves (a model whose 'mha' expert turns float32
    rounding into more; as `_close_to_cpu`'s `moved`, the CPU's own change
    is taken over the whole tree: which small leaves a rounding-sized
    change moves depends on where it enters). With `fused`, the gradient
    check runs again with the fused-combine train switch on in both models
    (the same weights), before the curve, which runs materialized."""
    from avmoe_tpu_torch.config import TrainConfig
    from avmoe_tpu_torch.train.freeze import freeze
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    tcfg = TrainConfig(accum_steps=1, lr=1e-5, lr_mlp=1e-5, decay=0.5, decay_epoch=1)
    kept = {k: v.clone() for k, v in cpu.state_dict().items()}
    runs_of = [("cpu", cpu, "cpu", False), ("card", gpu, "cuda", False)]
    if nudge:
        runs_of.append(("cpu nudged", cpu, "cpu", True))
    for route in (False, True) if fused else (False,):
        tag = f"{label} fused" if route else label
        grads = {}
        for name, model, dev, nudged in runs_of:
            _set_fused_(model, False, route)
            freeze(model, frozen_scopes)
            batch = batches(1, dev)[0]
            grads[name] = _trainable_grads(model, make_loss_fn(model),
                                           _nudged(batch) if nudged else batch, 0)
            model.load_state_dict(kept)             # the running stats as they were
            _set_fused_(model, False, False)
        whole, _, _ = _grad_cosines(grads["card"], grads["cpu"])
        leaves = _leaf_cosines(grads["card"], grads["cpu"])
        own = _leaf_cosines(grads["cpu nudged"], grads["cpu"]) if nudge else {}
        own_leaf = min(own, key=own.get) if own else None
        allowed = max(1e-4, 4.0 * (1.0 - own[own_leaf])) if own else 1e-4
        bad = {n: c for n, c in leaves.items() if 1.0 - c > allowed}
        leaf = min(leaves, key=leaves.get)
        low = leaves[leaf]
        by_own = sorted(n for n, c in leaves.items() if c < 0.9999 and n not in bad)
        check(whole >= 0.9999 and not bad, f"{tag} train gradients card vs CPU: cosine "
              f"{whole:.7f}; leaves past their bound {sorted(bad.items(), key=lambda kv: kv[1])[:5]}"
              f" (want >= 0.9999" + (f", or 1 - cosine <= {allowed:.3e}, 4x the CPU's own "
                                     f"largest under a 1e-6 input change)" if nudge else ")"))
        if nudge:
            log(f"[{tag}] the CPU's own gradients under a 1e-6 relative input change: lowest "
                f"leaf cosine {own[own_leaf]:.7f} ({own_leaf}); a card leaf may then be as low "
                f"as {1.0 - allowed:.7f}; " + (", ".join(
                    f"{n} {leaves[n]:.7f}" for n in sorted(by_own, key=leaves.get)[:8])
                    + f" ({len(by_own)} leaves below 0.9999)" if by_own
                    else "no leaf below 0.9999"))
        log(f"[{tag}] fp32 trainable gradients of one deterministic step, card (kernels) vs "
            f"CPU (plain): cosine {whole:.7f} (>= 0.9999), lowest per-leaf cosine {low:.7f} "
            f"({leaf}) (>= {1.0 - allowed:.7f})")
    if not steps:
        return
    counters = _train_counters()
    runs = {}
    with _deterministic():
        for name, model, dev in (("cpu", cpu, "cpu"), ("card", gpu, "cuda")):
            state = create_train_state(model, tcfg, steps_per_epoch=2,
                                       frozen_scopes=frozen_scopes)
            step = make_train_step(make_loss_fn(model))
            gen = torch.Generator(device=dev).manual_seed(0)
            for c in counters.values():
                c.launches = 0
            losses = []
            for batch in batches(steps, dev):
                state, met = step(state, batch, gen)
                losses.append(float(met["loss"]))
            runs[name] = (losses, {k: v.detach().cpu() for k, v in model.state_dict().items()},
                          {k: c.launches for k, c in counters.items()})
    (l_cpu, s_cpu, _), (l_gpu, s_gpu, n_gpu) = runs["cpu"], runs["card"]
    check(all(v > 0 for v in n_gpu.values()), f"{label} train: launches on the card {n_gpu}")
    check(np.allclose(l_gpu, l_cpu, rtol=1e-3, atol=0.0),
          f"{label} train losses: card {l_gpu} vs CPU {l_cpu}")
    worst = 0.0
    for k in s_cpu:
        a, b = s_gpu[k].float(), s_cpu[k].float()
        worst = max(worst, (a - b).abs().max().item())
        check(torch.allclose(a, b, rtol=1e-3, atol=1e-4), f"{label} train {k}: card vs CPU max "
              f"|d| {(a - b).abs().max().item():.3e}")
    log(f"[{label}] {steps} deterministic steps at lr 1e-5: losses "
        f"{[round(v, 6) for v in l_gpu]} "
        f"vs {[round(v, 6) for v in l_cpu]}; parameters and running stats max |d| {worst:.3e} "
        f"(rtol 1e-3, atol 1e-4); launches on the card {n_gpu}")


def phase_train_tiny():
    from avmoe_tpu_torch.config import tiny_ave_config
    from avmoe_tpu_torch.models.ave import AVEModel, make_ave_loss_fn

    cfg = tiny_ave_config()
    cpu = AVEModel(cfg, device="cpu", seed=0)
    _nonzero_gates_(cpu, 1)
    gpu = AVEModel(cfg, device="cuda", seed=None)
    gpu.load_state_dict(cpu.state_dict())
    _tiny_train_vs_cpu("train tiny", cpu, gpu, make_ave_loss_fn,
                       lambda n, dev: _train_batches(cfg, 2, n, 7, dev), steps=4)


def _plain_cores():
    """Stand-ins for K1's and K2's wrappers in `ops/swin.py`: their plain
    versions, in float32 whatever the model's dtype."""
    from avmoe_tpu_torch.kernels.mlp_block import mlp_block_plain
    from avmoe_tpu_torch.kernels.window_attention import window_attention_plain

    def attention(q, k, v, bias):
        return window_attention_plain(q.float(), k.float(), v.float(), bias).to(q.dtype)

    def mlp(x, ln_w, ln_b, w1, b1, w2, b2, *, pre_norm, eps=1e-5, scale=None, w1t=None,
            w2t=None):
        return mlp_block_plain(x.float(), ln_w, ln_b, w1.float(), b1, w2.float(), b2,
                               pre_norm=pre_norm, eps=eps, scale=scale).to(x.dtype)

    return attention, mlp


def _trainable_grads(model, loss_fn, batch, seed: int, cores=None):
    """{name: flattened float32 gradient} of the loss wrt the trainable
    parameters, one deterministic step; `cores` = (attention, mlp) replaces
    K1's and K2's wrappers for it (as `_plain_cores` gives them)."""
    import avmoe_tpu_torch.ops.swin as swin

    kept = swin.window_attention, swin.mlp_block
    if cores is not None:
        swin.window_attention, swin.mlp_block = cores
    try:
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        device = next(model.parameters()).device
        gen = torch.Generator(device=device).manual_seed(seed)
        with _deterministic():
            loss, _ = loss_fn(model, batch, gen)
            grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    finally:
        swin.window_attention, swin.mlp_block = kept
    return {n: (torch.zeros_like(p) if g is None else g).float().flatten().cpu()
            for (n, p), g in zip(named, grads)}


def _cosine_sums(a, b, device="cuda"):
    """(x . y, x . x, y . y) in float64 for each leaf of b (x from a, y from
    b), as a (leaves, 3) CPU tensor. The sums run on `device` a leaf at a
    time: on the host they took ~4 s for a full-width model's gradients."""
    rows = []
    for n in b:
        x, y = a[n].to(device, torch.float64), b[n].to(device, torch.float64)
        rows.append(torch.stack([torch.dot(x, y), torch.dot(x, x), torch.dot(y, y)]))
    return torch.stack(rows).cpu()


def _cos(xy, xx, yy) -> float:
    """x . y / (max(|x|, 1e-8) max(|y|, 1e-8)), as F.cosine_similarity."""
    return float(xy / (max(math.sqrt(xx), 1e-8) * max(math.sqrt(yy), 1e-8)))


def _leaf_cosines(a, b, sums=None):
    """{leaf: cosine of a's and b's gradients}, in float64, over the leaves
    where b's rms is above 1e-5 of its largest leaf's. Below that a leaf's
    gradient is rounding (biases that a norm or a softmax right after them
    cancels, 1e-7 of the largest and less)."""
    s = (_cosine_sums(a, b) if sums is None else sums).tolist()
    rms = {n: math.sqrt(s[i][2] / b[n].numel()) for i, n in enumerate(b)}
    top = max(rms.values())
    return {n: _cos(*s[i]) for i, n in enumerate(b) if rms[n] > 1e-5 * top}


def _grad_cosines(a, b):
    """(cosine of the whole flattened gradients, the lowest per-leaf cosine
    (`_leaf_cosines`) and its leaf), in float64."""
    sums = _cosine_sums(a, b)
    leaves = _leaf_cosines(a, b, sums)
    worst = min(leaves, key=leaves.get)
    return _cos(*sums.sum(dim=0).tolist()), leaves[worst], worst


def phase_train_grads(loss_fn, batch):
    """One deterministic step's trainable gradients at full width (PERF.md
    section 6). float32 through the kernels (K1b, K2b) against float32
    through their plain versions, checked where the float32 gradient is well
    conditioned: at the seeded init, every leaf too (adapter gates zero, as
    flax initializes them: the gates' gradients come back through every
    later block), and as a whole with noised gates at depths 2-2-2-2 (the
    bottlenecks', routers' and latent tokens' gradients too; some small
    leaves, such as a router's bias, sit at the rounding there and flip
    sign). bf16 against float32, checked at the seeded init. (After the
    train steps, with the gates noised, the adapters' float32 gradient
    itself moves with the rounding, so nothing is read there.)"""
    import dataclasses

    from avmoe_tpu_torch.config import AVEConfig
    from avmoe_tpu_torch.models.ave import AVEModel
    from avmoe_tpu_torch.train.freeze import freeze

    cfg = AVEConfig()
    cut = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin, depths=(2, 2, 2, 2)),
                              htsat=dataclasses.replace(cfg.htsat, depths=(2, 2, 2, 2)))
    batch = dict(batch, mixup_lambda=torch.full((BATCH * cfg.num_segments,), 0.6,
                                                device="cuda"))
    plain = _plain_cores()
    read = {}
    for label, c in (("seeded init", cfg), ("depths 2-2-2-2, gates noised", cut)):
        m16 = AVEModel(c, dtype=torch.bfloat16, device="cuda", seed=0)
        if c is cut:
            _nonzero_gates_(m16, 1)
        f32 = AVEModel(c, dtype=torch.float32, device="cuda", seed=None)
        f32.load_state_dict(m16.state_dict())
        freeze(m16)
        freeze(f32)
        ref = _trainable_grads(f32, loss_fn, batch, 13)
        read[label] = {"f32 plain / f32": _grad_cosines(
            _trainable_grads(f32, loss_fn, batch, 13, cores=plain), ref)}
        if c is cfg:
            read[label]["bf16 / f32"] = _grad_cosines(
                _trainable_grads(m16, loss_fn, batch, 13), ref)
        del m16, f32, ref
        torch.cuda.empty_cache()
        log(f"[train] trainable gradients of one deterministic step, {label}: " + "; ".join(
            f"{k} cosine {w:.7f}, lowest leaf {lo:.7f} ({leaf})"
            for k, (w, lo, leaf) in read[label].items()))
    for label, want in (("seeded init", 0.9999), ("depths 2-2-2-2, gates noised", 0.999)):
        whole, low, leaf = read[label]["f32 plain / f32"]
        check(whole >= want, f"fp32 gradients through the kernels vs their plain versions, "
              f"{label}: cosine {whole:.7f} < {want}")
    whole, low, leaf = read["seeded init"]["f32 plain / f32"]
    check(low >= 0.9999, f"fp32 gradients through the kernels vs their plain versions, seeded "
          f"init: leaf {leaf} cosine {low:.7f} < 0.9999")
    cos = read["seeded init"]["bf16 / f32"][0]
    check(cos >= 0.99, f"bf16 vs fp32 trainable gradients cosine {cos:.5f} < 0.99")
    log("[train] checked: fp32 kernels vs plain cosine >= 0.9999, every leaf too, at the "
        "seeded init, and >= 0.999 at depths 2-2-2-2 with noised gates; bf16 vs fp32 cosine "
        ">= 0.99 at the seeded init")


def _checked_steps(label: str, model, state, step, batch, gen, want, stat_keys):
    """Three train steps of `step` on `batch`: each step's launches as `want`
    plans them and a finite loss; after them every frozen parameter
    bit-identical, every trainable one moved, and the running stats whose
    names hold each of `stat_keys` moved. Returns (launches of the last
    step, losses, frozen tensors, moved tensors)."""
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    start = {n: p.detach().clone() for n, p in state.trainable.items()}
    stats = {n: b.clone() for n, b in state.batch_stats.items()}
    counters = _train_counters()
    losses = []
    for i in range(3):
        for c in counters.values():
            c.launches = 0
        state, met = step(state, batch, gen)
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        check(got == want, f"{label} step {i}: launches {got}, want {want}")
        losses.append(float(met["loss"]))
        check(math.isfinite(losses[-1]), f"{label} step {i}: loss {losses[-1]}")
    check(all(torch.equal(p, frozen[n]) for n, p in model.named_parameters() if n in frozen),
          f"{label}: a frozen parameter changed")
    moved = [n for n, p in state.trainable.items() if not torch.equal(p, start[n])]
    check(len(moved) == len(start), f"{label}: trainable parameters unchanged: "
          f"{sorted(set(start) - set(moved))[:5]}")
    for key in stat_keys:
        names = [n for n in stats if key in n]
        check(names and all(not torch.equal(state.batch_stats[n], stats[n]) for n in names),
              f"{label}: {key} running stats did not move")
    return got, losses, len(frozen), len(moved)


def _step_times(label: str, step, state, batch, gen):
    """A train step's wall time (median of 3 synced steps after a warm-up),
    its peak memory and a profile where `PROFILED` names it: (step ms, peak
    GiB, profile)."""
    torch.cuda.reset_peak_memory_stats()
    step(state, batch, gen)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = float(np.median(times)) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[time] {label} bf16 batch {BATCH} (default path): median {step_ms:.2f} ms over "
        f"3 steps ({', '.join(f'{t * 1e3:.2f}' for t in times)} ms), {BATCH / step_ms * 1e3:.3f} "
        f"clips/s; peak memory {peak:.2f} GiB")
    prof = phase_profile(label, lambda: step(state, batch, gen), step_ms, what="train step")
    return step_ms, peak, prof


def phase_train(model):
    """The full AVEConfig() train step in bf16 on the default path."""
    from avmoe_tpu_torch.config import AVEConfig, TrainConfig
    from avmoe_tpu_torch.models.ave import make_ave_loss_fn
    from avmoe_tpu_torch.moe.injection import backward_launches, kernel_launches
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    cfg = AVEConfig()
    state = create_train_state(model, TrainConfig(accum_steps=1), steps_per_epoch=100)
    loss_fn = make_ave_loss_fn(model, mixup_alpha=0.5)
    step = make_train_step(loss_fn)
    batch = _train_batches(cfg, BATCH, 1, 11, "cuda")[0]
    batch.pop("mixup_lambda")                   # λ drawn per frame from Beta(0.5, 0.5)
    fwd = kernel_launches(cfg.swin, cfg.htsat, cfg.injection, block_chains=False)
    want = {"K1": fwd["K1"], "K2": fwd["K2"], **backward_launches(cfg.swin, cfg.htsat,
                                                                   cfg.injection)}
    gen = torch.Generator(device="cuda").manual_seed(12)
    got, losses, n_frozen, n_moved = _checked_steps("train", model, state, step, batch, gen,
                                                    want, ("bn0", "moe"))
    log(f"[train] AVEConfig() bf16 batch {BATCH}, default path, DropPath + SpecAugment + dropout "
        f"+ mixup: losses {[round(v, 5) for v in losses]}; {n_frozen} frozen tensors "
        f"bit-identical, {n_moved} trainable tensors moved, bn0 and adapter running stats "
        f"moved; launches per step {got} (plan {want})")

    phase_train_grads(loss_fn, batch)
    step_ms, _, prof = _step_times("train step", step, state, batch, gen)
    return got, step_ms, prof


# ---------------------------------------------------------------------------
# The fused bottleneck-rank MoE combine (moe/adapter.py), t-SNE and the
# data-parallel dry run at world size 1 on NCCL
# ---------------------------------------------------------------------------


def _set_fused_(model, eval_on: bool, train_on: bool) -> int:
    """Both fused-combine switches of every MoEAdapter of `model`, in place;
    returns the adapters set."""
    from avmoe_tpu_torch.moe.adapter import MoEAdapter

    adapters = [m for m in model.modules() if isinstance(m, MoEAdapter)]
    for m in adapters:
        m.fused_moe, m.fused_moe_train = eval_on, train_on
    return len(adapters)


def _peak_gib(run) -> float:
    """Peak memory of one synced run(), GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def phase_fused_moe(model, mat_fwd_prof, mat_step_prof) -> dict:
    """The fused combine on the full AVEConfig() (every adapter switched on
    `model`, the bf16 model of phase_full and phase_train, gates noised):
    the bf16 batch-4 eval forward fused against materialized (logits and
    gating cosines >= 0.999, K1 / K2 launches equal to the materialized
    route's and to the plan); one float32 train step's trainable gradients
    fused against materialized at the seeded init with the gates at 1e-2
    scale (every expert live, the gradient as well conditioned as at the
    seeded init), on the card in float64 (whole and every live leaf >=
    0.9999) and the BN running statistics after it (rtol 1e-3, atol 1e-4,
    the card-vs-CPU bound of the tiny train phases: the fused trunk's
    closed-form LayerNorm variance cancels where a row's mean is large);
    three bf16 fused train steps with phase_train's checks (launches as
    planned, frozen bit-identical, every trainable moved, bn0 and adapter
    statistics moved); the two routes' eval and train-step walls and peaks,
    timed here one after the other, and device busy (the materialized
    route's from phase_full's and phase_train's profiles)."""
    from avmoe_tpu_torch.config import AVEConfig, TrainConfig
    from avmoe_tpu_torch.models.ave import AVEModel, make_ave_loss_fn
    from avmoe_tpu_torch.moe.injection import backward_launches, kernel_launches
    from avmoe_tpu_torch.train.freeze import freeze
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    cfg = AVEConfig()
    wave, imgs = _inputs(cfg, BATCH, 3, "cuda")
    counters = _counters()
    want = kernel_launches(cfg.swin, cfg.htsat, cfg.injection, block_chains=False)
    outs, got, peaks = {}, {}, {}
    for route, on in (("materialized", False), ("fused", True)):
        n_adapters = _set_fused_(model, on, False)
        for c in counters.values():
            c.launches = 0
        outs[route] = model(wave, imgs)
        torch.cuda.synchronize()
        got[route] = {k: c.launches for k, c in counters.items()}
        peaks[route] = _peak_gib(lambda: model(wave, imgs))
    check(n_adapters == 32, f"fused: {n_adapters} adapters, want 32")
    check(got["fused"] == got["materialized"] == want,
          f"fused eval: launches fused {got['fused']}, materialized {got['materialized']}, "
          f"plan {want}")
    cos = F.cosine_similarity(_logits(outs["fused"]), _logits(outs["materialized"]),
                              dim=0).item()
    gating = min(F.cosine_similarity(outs["fused"]["telemetry"][k].float().flatten(),
                                     outs["materialized"]["telemetry"][k].float().flatten(),
                                     dim=0).item() for k in GATING)
    check(cos >= 0.999 and gating >= 0.999, f"fused eval bf16: logits cosine {cos:.6f}, "
          f"lowest gating cosine {gating:.6f} against the materialized combine (>= 0.999)")
    log(f"[fused] AVEConfig() bf16 batch {BATCH} eval, fused vs materialized combine: logits "
        f"cosine {cos:.6f}, lowest gating cosine {gating:.6f} (>= 0.999); launches {got['fused']}"
        f" both (plan {want}); peak memory {peaks['fused']:.2f} / {peaks['materialized']:.2f} "
        f"GiB")
    del outs
    _set_fused_(model, False, False)
    mat_fwd_ms = _times(model, "materialized combine", wave, imgs, batch1=False)
    _set_fused_(model, True, False)
    fwd_ms = _times(model, "fused combine", wave, imgs, batch1=False)
    fwd_prof = phase_profile("fused eval", lambda: model(wave, imgs), fwd_ms)

    # float32 train step, fused vs materialized, from the same state: the
    # seeded init with its adapter gates at 1e-2 scale, so that every
    # expert's gradient is live while the float32 gradient stays as well
    # conditioned as at the seeded init (with gates at 0.5 +- 0.2 a 1e-6
    # relative input change moves it to cosine 0.64: phase_train_grads)
    loss_fn = make_ave_loss_fn(model, mixup_alpha=0.5)
    batch = _train_batches(cfg, BATCH, 1, 11, "cuda")[0]
    f32 = AVEModel(cfg, dtype=torch.float32, device="cuda", seed=0)
    g = torch.Generator(device="cpu").manual_seed(2)
    with torch.no_grad():
        for n, p in f32.named_parameters():
            if n.rsplit(".", 1)[-1] in ("gate", "gate_av"):
                p.copy_(1e-2 * torch.randn(p.shape, generator=g))
    freeze(f32)
    kept = {k: v.clone() for k, v in f32.state_dict().items()}
    grads, stats = {}, {}
    for route, on in (("materialized", False), ("fused", True)):
        _set_fused_(f32, False, on)
        f32.load_state_dict(kept)
        grads[route] = _trainable_grads(f32, loss_fn, batch, 13)
        stats[route] = {n: b.clone() for n, b in f32.named_buffers()
                        if n.endswith(("running_mean", "running_var"))}
    whole = _grad_cosines(grads["fused"], grads["materialized"])[0]
    leaves = _leaf_cosines(grads["fused"], grads["materialized"])
    leaf = min(leaves, key=leaves.get)
    low = leaves[leaf]
    check(whole >= 0.9999 and low >= 0.9999, f"fused train fp32: trainable gradients against "
          f"the materialized combine: cosine {whole:.7f}, lowest leaf {low:.7f} ({leaf})")
    worst = 0.0
    for n, b in stats["materialized"].items():
        a = stats["fused"][n]
        worst = max(worst, (a - b).abs().max().item())
        check(torch.allclose(a, b, rtol=1e-3, atol=1e-4), f"fused train fp32 {n}: running stats "
              f"max |d| {(a - b).abs().max().item():.3e}")
    moved = sum(not torch.equal(stats["fused"][n], kept[n]) for n in stats["fused"])
    check(moved == len(stats["fused"]), f"fused train fp32: {len(stats['fused']) - moved} "
          f"running stats did not move")
    log(f"[fused] AVEConfig() fp32 batch {BATCH} train step (seeded init, gates at 1e-2 scale, "
        f"deterministic, λ given), fused vs materialized: trainable gradients cosine "
        f"{whole:.7f}, lowest of {len(leaves)} live leaves {low:.7f} ({leaf}) (>= 0.9999, "
        f"float64 sums on the card); {len(stats['fused'])} running stats moved, max |d| "
        f"{worst:.3e} (rtol 1e-3, atol 1e-4)")
    del f32, kept, grads, stats
    torch.cuda.empty_cache()

    _set_fused_(model, True, True)
    state = create_train_state(model, TrainConfig(accum_steps=1), steps_per_epoch=100)
    step = make_train_step(loss_fn)
    batch.pop("mixup_lambda")
    plan = {"K1": want["K1"], "K2": want["K2"],
            **backward_launches(cfg.swin, cfg.htsat, cfg.injection)}
    gen = torch.Generator(device="cuda").manual_seed(12)
    got_step, losses, n_frozen, n_moved = _checked_steps("fused train", model, state, step,
                                                         batch, gen, plan, ("bn0", "moe"))
    log(f"[fused] AVEConfig() bf16 batch {BATCH} train steps, fused combine: losses "
        f"{[round(v, 5) for v in losses]}; {n_frozen} frozen tensors bit-identical, {n_moved} "
        f"trainable tensors moved; launches per step {got_step} (plan {plan})")
    step_ms, step_peak, step_prof = _step_times("fused train step", step, state, batch, gen)
    _set_fused_(model, False, False)
    mat_step_ms, mat_step_peak, _ = _step_times("materialized train step", step, state, batch,
                                                gen)
    routes = {
        "materialized": {"eval_ms": mat_fwd_ms, "eval_device_busy_ms": mat_fwd_prof[0],
                         "eval_peak_gib": peaks["materialized"], "train_step_ms": mat_step_ms,
                         "train_device_busy_ms": mat_step_prof[0],
                         "train_peak_gib": mat_step_peak},
        "fused": {"eval_ms": fwd_ms, "eval_device_busy_ms": fwd_prof[0],
                  "eval_peak_gib": peaks["fused"], "train_step_ms": step_ms,
                  "train_device_busy_ms": step_prof[0], "train_peak_gib": step_peak}}
    busy = lambda prof: "not profiled" if prof[0] is None else f"{prof[0]:.2f}"
    log(f"[time] {_card_line()}: AVE bf16 batch {BATCH}, fused / materialized combine: eval "
        f"{fwd_ms:.2f} / {mat_fwd_ms:.2f} ms wall, {busy(fwd_prof)} / {busy(mat_fwd_prof)} ms "
        f"device busy, {peaks['fused']:.2f} / {peaks['materialized']:.2f} GiB peak; train step "
        f"{step_ms:.2f} / {mat_step_ms:.2f} ms wall, {busy(step_prof)} / {busy(mat_step_prof)} "
        f"ms device busy, {step_peak:.2f} / {mat_step_peak:.2f} GiB peak")
    return {"clips": BATCH, "eval_logits_cosine": cos, "eval_gating_cosine": gating,
            "train_grad_cosine": whole, "train_lowest_leaf_cosine": low,
            "launches_per_forward": got["fused"], "launches_per_step": got_step,
            "routes": routes}


def phase_tsne(model) -> dict:
    """t-SNE (`utils/tsne.py`) of 200 pooled visual features of the AVE eval
    (5 batches of 4 clips, 10 frames each, through `model`'s encoder) on the
    card against the CPU: the KL gradient at a mid-descent embedding (50
    CPU iterations), with and without the exaggeration, within 1e-4 of its
    largest entry; the default descent's first 3 iterations within 1e-4 of
    the embedding's extent (later the descent is chaotic: float32 rounding
    grows into another local minimum); then the default 500 iterations on
    the card, finite, timed."""
    from avmoe_tpu_torch.config import AVEConfig
    from avmoe_tpu_torch.utils.tsne import _kl_grad, joint_probs, tsne

    cfg = AVEConfig()
    feats = []
    with torch.no_grad():
        for seed in range(5):
            wave, imgs = _inputs(cfg, BATCH, 40 + seed, "cuda")
            f_v, _, _ = model.encoder(wave.reshape(BATCH * 10, -1),
                                      imgs.reshape((BATCH * 10,) + tuple(imgs.shape[2:])))
            feats.append(f_v.float().cpu())
    x = torch.cat(feats).numpy()
    P = torch.from_numpy(joint_probs(x)).float()
    y = torch.from_numpy(tsne(x, n_iter=50, device="cpu"))
    worst = {}
    for exag in (12.0, 1.0):
        card = _kl_grad(y.cuda(), P.cuda(), exag).cpu()
        cpu = _kl_grad(y, P, exag)
        worst[f"kl_grad_exaggeration_{exag:g}"] = float((card - cpu).abs().max()
                                                        / cpu.abs().max())
    card = tsne(x, n_iter=3, device="cuda")
    cpu = tsne(x, n_iter=3, device="cpu")
    worst["3_iterations"] = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    check(all(v <= 1e-4 for v in worst.values()), f"t-SNE card vs CPU: {worst} (<= 1e-4)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = tsne(x, device="cuda")
    ms = (time.perf_counter() - t0) * 1e3
    check(emb.shape == (x.shape[0], 2) and np.isfinite(emb).all(), "t-SNE: default run")
    log(f"[tsne] {x.shape[0]} AVE features ({x.shape[1]}-d): card vs CPU, max |d| over the "
        f"largest: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (<= 1e-4); the default 500 iterations on the card in {ms:.1f} ms")
    return {"points": int(x.shape[0]), "card_vs_cpu": worst, "default_run_ms": ms}


def phase_dryrun() -> None:
    """`parallel/dryrun.py` at world size 1 on NCCL: 3 tiny AVE train steps
    under a process group of one (every batch reduction and the gradient
    all-reduce through NCCL) against the same steps without one, both in
    this process, then the eval pass with telemetry."""
    from avmoe_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    out = dryrun.dryrun(1, ("ave",), steps=3, device="cuda")["ave"]
    rank = out["ranks"][0]
    check(rank["world_size"] == 1 and rank["grad_allreduces"] == 6,
          f"dryrun: world size {rank['world_size']}, {rank['grad_allreduces']} all-reduces")
    log(f"[dryrun] tiny AVE, 3 steps at world size 1 on NCCL against one process: losses "
        f"{[round(v, 6) for v in rank['curve']]} vs "
        f"{[round(v, 6) for v in out['reference']['curve']]}; largest differences "
        f"{out['worst']}; {rank['grad_allreduces']} gradient all-reduces; "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Reference checkpoints (avmoe_tpu_torch/checkpoint/convert.py) into the full
# AVE model, and the audio-statistics tool on the card
# ---------------------------------------------------------------------------


def _reference_layout():
    """tests/torch_reference_layout.py: reference state dicts written from
    flax-layout trees, and seeded trees (numpy only)."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_reference_layout

    return torch_reference_layout


def _seeded_tree(module, ref, seed: int):
    """Seeded noise in the shape of `module`'s flax tree, as numpy float32."""
    from avmoe_tpu_torch.convert import export_jax_variables

    return ref.seeded_variables(export_jax_variables(module), seed)


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _mlp_caches_current(model, label: str) -> int:
    """Every Swin block's compute-dtype MLP weights, as its K2 reads them,
    equal its weights now. Returns the blocks checked."""
    from avmoe_tpu_torch.ops.swin import SwinBlock

    blocks = [m for m in model.modules() if isinstance(m, SwinBlock)]
    for blk in blocks:
        w1, w2, _, _ = blk._mlp_weights(torch.bfloat16, False)
        check(torch.equal(w1, blk.mlp.fc1.weight.to(torch.bfloat16))
              and torch.equal(w2, blk.mlp.fc2.weight.to(torch.bfloat16)),
              f"{label}: a block's cached MLP weights are stale")
    return len(blocks)


def _converted_cosines(model, f32, wave, imgs, label: str, paths) -> dict:
    """bf16 `model` against the float32 `f32` (same weights) on each path:
    the plan's K1 / K2 / K3 launches, finite logits, cosine >= 0.99."""
    from avmoe_tpu_torch.moe.injection import kernel_launches

    cfg = model.cfg
    counters = _counters()
    out, cos = {}, {}
    for chains in paths:
        path = "chain path" if chains else "default path"
        model.encoder.block_chains = f32.encoder.block_chains = chains
        for c in counters.values():
            c.launches = 0
        out[path] = model(wave, imgs)
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        want = kernel_launches(cfg.swin, cfg.htsat, cfg.injection, chains)
        check(got == want, f"{label} {path}: launches {got}, want {want}")
        check(bool(torch.isfinite(_logits(out[path])).all()), f"{label} {path}: logits not finite")
        ref = f32(wave, imgs)
        cos[path] = F.cosine_similarity(_logits(out[path]), _logits(ref), dim=0).item()
        check(cos[path] >= 0.99, f"{label} {path}: bf16 vs fp32 logits cosine "
                                 f"{cos[path]:.5f} < 0.99")
        log(f"[convert] {label}, {path}: launches {got}, bf16 vs fp32 logits cosine "
            f"{cos[path]:.6f} (>= 0.99)")
    model.encoder.block_chains = f32.encoder.block_chains = False
    if len(paths) == 2:
        cos["chain vs default"] = F.cosine_similarity(
            _logits(out["chain path"]), _logits(out["default path"]), dim=0).item()
        check(cos["chain vs default"] >= 0.99, f"{label}: bf16 chain vs default logits cosine "
                                              f"{cos['chain vs default']:.5f} < 0.99")
        log(f"[convert] {label}: bf16 chain path vs default path logits cosine "
            f"{cos['chain vs default']:.6f} (>= 0.99)")
    return cos


def phase_convert(model):
    """A full-width MMIL_Net-layout state dict (24 Swin-V2-L blocks, 12
    HTS-AT blocks, 8 sites x 4 adapters, temporal_attn.*, CMBS.*, and the
    keys of the reference modules no converter reads), made from seeded
    noise, converted by `convert_mmil_net` and loaded into the AVEConfig()
    bf16 model of phase 7 in place; then timm- and HTS-AT-layout backbone
    dicts grafted into it by `graft_backbones`. Checks: every tensor changed
    on the load (the graft: every backbone tensor, nothing else), every Swin
    block's cached bf16 MLP weights current, and the batch-4 eval logits
    against a float32 model of the same weights on both paths (after the
    graft on the default path), cosine >= 0.99, chain vs default too."""
    import resource

    from avmoe_tpu_torch.checkpoint.convert import (KeyLog, convert_mmil_net, graft_backbones,
                                                    strip_prefix)
    from avmoe_tpu_torch.convert import load_jax_variables
    from avmoe_tpu_torch.models.ave import AVEModel

    ref = _reference_layout()
    cfg = model.cfg
    t0 = time.perf_counter()
    tree = _seeded_tree(model, ref, 21)            # the model's own seed was 0
    sd = ref.mmil_net_state_dict(tree, dropped=True)
    make_s = time.perf_counter() - t0
    sd_gib = sum(v.nbytes for v in sd.values()) / 2**30
    log(f"[convert] reference MMIL_Net state dict: {len(sd)} keys, {sd_gib:.3f} GiB, made in "
        f"{make_s:.2f} s (host)")

    wave, imgs = _inputs(cfg, BATCH, 3, "cuda")
    model.encoder.block_chains = False
    model(wave, imgs)                         # the bf16 MLP caches hold the old weights
    before = _snapshot(model)
    t0 = time.perf_counter()
    keys = KeyLog(sd)
    params, stats = convert_mmil_net(keys, n_sites=ref.n_sites(tree["params"]["encoder"]),
                                     swin_depths=cfg.swin.depths, htsat_depths=cfg.htsat.depths)
    convert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_jax_variables(model, {"params": params, "batch_stats": stats})
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    dropped = keys.unread()
    log(f"[convert] convert_mmil_net {convert_s:.3f} s, load_jax_variables {load_s:.3f} s "
        f"(host, to the card); reference keys read {len(keys.read)}, dropped {len(dropped)} "
        f"(e.g. {dropped[:3]})")
    after = model.state_dict()
    same = [k for k in after if torch.equal(after[k], before[k])]
    check(not same, f"converted load: tensors unchanged: {same[:5]}")
    n_blocks = _mlp_caches_current(model, "converted load")
    log(f"[convert] all {len(after)} tensors changed on the load; {n_blocks} blocks' bf16 MLP "
        f"weight caches current")
    del params, stats, before

    f32 = AVEModel(cfg, dtype=torch.float32, device="cuda", seed=None)
    f32.load_state_dict(model.state_dict())
    cos = _converted_cosines(model, f32, wave, imgs, "converted", (False, True))

    t0 = time.perf_counter()
    swin_sd = ref.swinv2_timm_state_dict(_seeded_tree(model.encoder.swin, ref, 22)["params"],
                                         dropped=True)
    h = _seeded_tree(model.encoder.htsat, ref, 23)
    htsat_sd = {"sed_model." + k: v for k, v in ref.htsat_state_dict(
        h["params"], h["batch_stats"], dropped=True).items()}
    graft_make_s = time.perf_counter() - t0
    before = _snapshot(model)
    t0 = time.perf_counter()
    graft_backbones(model, swin_sd=swin_sd, htsat_sd=strip_prefix(htsat_sd, "sed_model."))
    torch.cuda.synchronize()
    graft_s = time.perf_counter() - t0
    after = model.state_dict()
    backbone = [k for k in after if k.startswith(("encoder.swin.", "encoder.htsat."))]
    check(backbone and all(not torch.equal(after[k], before[k]) for k in backbone),
          "graft: a backbone tensor unchanged")
    check(all(torch.equal(after[k], before[k]) for k in after if k not in backbone),
          "graft: a tensor outside the backbones changed")
    _mlp_caches_current(model, "graft")
    log(f"[convert] graft_backbones {graft_s:.3f} s (dicts made in {graft_make_s:.2f} s): "
        f"{len(swin_sd)} timm + {len(htsat_sd)} HTS-AT keys, all {len(backbone)} backbone "
        f"tensors changed, the other {len(after) - len(backbone)} bit-identical")
    f32.load_state_dict(model.state_dict())
    cos["grafted default path"] = _converted_cosines(model, f32, wave, imgs, "grafted",
                                                     (False,))["default path"]
    del f32, before, after
    torch.cuda.empty_cache()
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(f"[convert] host peak RSS so far {rss:.2f} GiB")
    return {"reference_keys": len(sd), "reference_gib": sd_gib, "keys_read": len(keys.read),
            "keys_dropped": len(dropped), "make_s": make_s, "convert_s": convert_s,
            "load_s": load_s, "graft_s": graft_s, "host_peak_rss_gib": rss,
            "bf16_vs_f32_cosines": cos}


def phase_audio_stats():
    """`cli/compute_audio_stats.py` over 32 synthetic 10-s packs at 16 kHz
    (its defaults: 192 mel bins, a 5.2-ms shift) on the card and with
    --device cpu: mean and std within rtol 1e-4; the tool's wall time on
    each, and fbank alone on the card in frames per second (one batch of
    16 packs, float64 as the tool runs it, and float32)."""
    import shutil
    import tempfile

    from avmoe_tpu_torch.audio.kaldi import fbank
    from avmoe_tpu_torch.cli import compute_audio_stats

    tmp = tempfile.mkdtemp(prefix="audio_stats_")
    try:
        rng = np.random.RandomState(31)
        t = np.arange(16_000) / 16_000.0
        for i in range(32):
            tone = np.sin(2 * np.pi * rng.uniform(100.0, 4000.0) * t)
            pack = rng.uniform(0.01, 0.5) * (0.3 * rng.randn(10, 16_000) + tone)
            np.save(os.path.join(tmp, f"clip{i:02d}.npy"), pack.astype(np.float32))
        res, wall = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res[dev] = compute_audio_stats.main(["--wave_dir", tmp, "--device", dev])
            torch.cuda.synchronize()
            wall[dev] = time.perf_counter() - t0
        for i, what in enumerate(("mean", "std")):
            a, b = res["cuda"][i], res["cpu"][i]
            check(math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b),
                  f"audio stats {what}: card {a!r} vs CPU {b!r} (rtol 1e-4)")
        files = sorted(os.listdir(tmp))[:compute_audio_stats.PACKS_PER_BATCH]
        waves = np.stack([np.load(os.path.join(tmp, f)).reshape(-1) for f in files])
        kw = dict(sample_frequency=16_000.0, num_mel_bins=192, frame_shift_ms=5.2)
        rates = {}
        for dt in (torch.float64, torch.float32):
            x = torch.from_numpy(waves).to("cuda", dt)
            frames = math.prod(fbank(x, **kw).shape[:2])
            ms = time_ms(lambda: fbank(x, **kw), iters=20, warmup=3)
            rates[str(dt).split(".")[-1]] = {"ms": ms, "frames_per_s": frames / ms * 1e3}
        log(f"[audio stats] 32 packs of 10 s at 16 kHz: mean {res['cuda'][0]!r} std "
            f"{res['cuda'][1]!r} on the card, {res['cpu'][0]!r} / {res['cpu'][1]!r} on the "
            f"CPU (rtol 1e-4); tool wall time {wall['cuda']:.3f} s card, {wall['cpu']:.3f} s "
            f"CPU; fbank of {len(files)} packs on the card: "
            + ", ".join(f"{k} {v['ms']:.3f} ms, {v['frames_per_s']:.0f} frames/s"
                        for k, v in rates.items()))
        return {"card": res["cuda"], "cpu": res["cpu"], "wall_s": wall, "fbank": rates}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# The rest of AVE: the head settings and flavor presets, and the driver
# (avmoe_tpu_torch/cli/train_ave.py) run in-process at full width
# ---------------------------------------------------------------------------


AVE_HEADS = ({"is_inter_in_cmbs": True}, {"is_temporal_att": False}, {"is_cmbs": False})


def phase_ave_heads_tiny():
    """The tiny AVE model with each head setting of the rest of AVE, card
    (kernels) vs CPU (plain versions), float32, rtol 1e-3, atol 1e-4."""
    import dataclasses

    from avmoe_tpu_torch.config import tiny_ave_config
    from avmoe_tpu_torch.models.ave import AVEModel

    for head in AVE_HEADS:
        cfg = dataclasses.replace(tiny_ave_config(), **head)
        cpu = AVEModel(cfg, device="cpu", seed=0)
        _nonzero_gates_(cpu, 1)
        wave, imgs = _inputs(cfg, 2, 2, "cpu")
        ref = cpu(wave, imgs)
        gpu = AVEModel(cfg, device="cuda", seed=None)
        gpu.load_state_dict(cpu.state_dict())
        out = gpu(wave.cuda(), imgs.cuda())
        keys = (("segment_probs",) if not cfg.is_cmbs
                else ("is_event_logits", "event_logits", "av_score"))
        worst = 0.0
        for key in keys + ("audio_p1", "audio_p2", "video_p1", "video_p2"):
            a = (out[key] if key in out else out["telemetry"][key]).cpu()
            b = ref[key] if key in ref else ref["telemetry"][key]
            worst = max(worst, (a - b).abs().max().item())
            check(torch.allclose(a, b, rtol=1e-3, atol=1e-4),
                  f"tiny AVE {head} {key}: card vs CPU max |d| {(a - b).abs().max().item():.3e}")
        log(f"[ave heads] tiny AVE fp32 {head}: card (kernels) vs CPU (plain) max |d| "
            f"{worst:.3e} over {', '.join(keys)} and the gating probs (rtol 1e-3, atol 1e-4)")


def phase_ave_flavor():
    """ave_flavor_config('scv2', 'base') at full width in bf16: the eval
    forward at batch 4 with the launches of the plan and the bf16-vs-fp32
    logits cosine; then train steps with their launches, frozen weights
    bit-identical and every trainable one moved."""
    from avmoe_tpu_torch.config import TrainConfig, ave_flavor_config
    from avmoe_tpu_torch.models.ave import AVEModel, make_ave_loss_fn
    from avmoe_tpu_torch.moe.injection import backward_launches, kernel_launches
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    cfg, _ = ave_flavor_config("scv2", "base")
    model = AVEModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    _nonzero_gates_(model, 1)
    wave, imgs = _inputs(cfg, BATCH, 3, "cuda")
    fwd = kernel_launches(cfg.swin, cfg.htsat, cfg.injection, block_chains=False)
    outs, fwd_got = _drive(model, "scv2/base default path", fwd, wave, imgs)
    f32 = AVEModel(cfg, dtype=torch.float32, device="cuda", seed=None)
    f32.load_state_dict(model.state_dict())
    cos = F.cosine_similarity(_logits(outs[BATCH]), _logits(f32(wave, imgs)), dim=0).item()
    check(cos >= 0.99, f"scv2/base: bf16 vs fp32 logits cosine {cos:.5f} < 0.99")
    del f32
    torch.cuda.empty_cache()
    log(f"[ave flavor] scv2 HTS-AT (16 kHz, hop 160) + Swin-V2-B bf16 batch {BATCH}: launches "
        f"{fwd_got} (plan {fwd}); bf16 vs fp32 logits cosine {cos:.6f} (>= 0.99)")
    state = create_train_state(model, TrainConfig(accum_steps=1), steps_per_epoch=100)
    step = make_train_step(make_ave_loss_fn(model, mixup_alpha=0.5))
    batch = _train_batches(cfg, BATCH, 1, 11, "cuda")[0]
    batch.pop("mixup_lambda")
    want = {"K1": fwd["K1"], "K2": fwd["K2"],
            **backward_launches(cfg.swin, cfg.htsat, cfg.injection)}
    gen = torch.Generator(device="cuda").manual_seed(12)
    got, losses, n_frozen, n_moved = _checked_steps("scv2/base train", model, state, step, batch,
                                                    gen, want, ("bn0", "moe"))
    log(f"[ave flavor] scv2/base bf16 train steps: losses {[round(v, 5) for v in losses]}; "
        f"{n_frozen} frozen tensors bit-identical, {n_moved} trainable tensors moved; launches "
        f"per step {got} (plan {want})")
    return {"eval_launches": fwd_got, "bf16_vs_f32_cosine": cos, "step_launches": got}


class _CliProbe:
    """What the CLI phases read from inside a driver's `main`: the driver's
    step, eval step or `evaluate`, checkpoint manager and loaders are
    wrapped (in the module's namespace, for the run) to record each step's
    start time, loss, learning rate and state, each eval batch's accuracy
    and expert telemetry (AVE's eval step) or each evaluation's result, the
    eval batches, the train loader's consumer waits, and each checkpoint
    save's and restore's time and size. At the first step it copies the
    weights and running stats, and compares the state with `resume_from`
    (a checkpoint payload) and the named tensors of `graft_from`."""

    def __init__(self, resume_from=None, graft_from=None):
        self.step_starts, self.losses, self.update_lrs = [], [], []
        self.evals, self.results, self.waits, self.saves, self.restores = [], [], [], [], []
        self.eval_batches = 0
        self.state = self.initial = self.initial_stats = None
        self.resume_from = resume_from     # the CheckpointManager payload to hold the state to
        self.resume_diff = None
        self.graft_from = graft_from       # {name: tensor} the model must start from
        self.graft_diff = None

    def patch(self, mod):
        probe = self
        make_train_step = mod.make_train_step
        make_eval_step, evaluate = getattr(mod, "make_eval_step", None), getattr(mod, "evaluate",
                                                                                None)
        Manager, Loader = mod.CheckpointManager, mod.BatchLoader

        def wrapped_train_step(loss_fn):
            step = make_train_step(loss_fn)

            def run(state, batch, gen):
                if probe.state is None:
                    probe.state = state
                    probe.first_step(state)
                probe.step_starts.append(time.perf_counter())
                state, met = step(state, batch, gen)
                probe.losses.append(met["loss"])
                if state.mini_step == 0:
                    probe.update_lrs.append([g["lr"] for g in state.optimizer.param_groups])
                return state, met
            return run

        def wrapped_eval_step(eval_fn):
            step = make_eval_step(eval_fn)

            def run(state, batch):
                out = step(state, batch)
                probe.evals.append({k: v.detach().clone() for k, v in
                                    [("accuracy", out["accuracy"]), *out["telemetry"].items()]
                                    if torch.is_tensor(v)})
                return out
            return run

        class TimedManager(Manager):
            def save(self, step, state, metrics=None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                super().save(step, state, metrics)
                probe.saves.append((time.perf_counter() - t0, os.path.getsize(
                    os.path.join(self.step_dir(step), "state.pt"))))

            def restore(self, state, step=None, params_only=False):
                t0 = time.perf_counter()
                out = super().restore(state, step, params_only)
                torch.cuda.synchronize()
                probe.restores.append(time.perf_counter() - t0)
                return out

        def wrapped_evaluate(*args, **kwargs):
            out = evaluate(*args, **kwargs)
            probe.results.append(out)
            return out

        class TimedLoader(Loader):
            def __iter__(self):
                it = super().__iter__()
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    if self.shuffle:                   # the train loader
                        probe.waits.append(time.perf_counter() - t0)
                    else:
                        probe.eval_batches += 1
                    yield batch

        names = {"make_train_step": wrapped_train_step, "CheckpointManager": TimedManager,
                 "BatchLoader": TimedLoader}
        if make_eval_step is not None:
            names["make_eval_step"] = wrapped_eval_step
        if evaluate is not None:
            names["evaluate"] = wrapped_evaluate
        return names

    def first_step(self, state):
        self.initial = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        self.initial_stats = {n: b.clone() for n, b in state.batch_stats.items()}
        if self.graft_from is not None:
            model = state.model.state_dict()
            self.graft_diff = [n for n, t in self.graft_from.items()
                               if not torch.equal(model[n], t.to(model[n].device))]
        if self.resume_from is None:
            return
        saved, diff = self.resume_from, []
        model = state.model.state_dict()
        diff += [k for k, v in saved["model"].items()
                 if not torch.equal(model[k], v.to(model[k].device))]
        opt = state.optimizer.state_dict()["state"]
        for i, s in saved["optimizer"]["state"].items():
            diff += [f"optimizer {i} {k}" for k, v in s.items()
                     if not torch.equal(torch.as_tensor(opt[i][k]).cpu(), v.cpu())]
        acc = state.acc_grads or []
        if len(acc) != len(saved["acc_grads"] or []) or not all(
                torch.equal(a, b.to(a.device)) for a, b in zip(acc, saved["acc_grads"] or [])):
            diff.append("acc_grads")
        for k in ("step", "updates", "mini_step"):
            if getattr(state, k) != saved[k]:
                diff.append(k)
        self.resume_diff = diff


def _saved_payload(manager):
    """The latest checkpoint's payload for `_CliProbe`'s resume check,
    memory-mapped on the host: each tensor is read where it is compared,
    from the page cache the save left, instead of the whole file being
    deserialized and copied to the card first (7.8 s for S4's 4.885-GB
    checkpoint on an H100 machine)."""
    from avmoe_tpu_torch.checkpoint.manager import STATE_FILE

    return torch.load(os.path.join(manager.step_dir(manager.latest_step()), STATE_FILE),
                      map_location="cpu", mmap=True, weights_only=True)


def _adapter_of(name: str):
    """The adapter module of a trainable parameter ('audio_moe_p1_0', or a
    legacy model's 'audio_adapter_p1_0'), or None."""
    parts = name.split(".")
    if parts[0] == "encoder":
        parts = parts[1:]
    return parts[0] if re.fullmatch(r"(audio|vis)_(moe|adapter)_p[12]_\d+", parts[0]) else None


# The adapters whose expert gates stall at the AVE CLI's seeded init on the
# card: zero gates and biases (the flax init) let SpecAugment's zeroed stripes
# give HTS-AT all-zero patch tokens, whose LayerNorm backward multiplies the
# gradient by 1/sqrt(eps) twice a block; the first audio sites' gates then get
# gradients whose square overflows Adam's float32 second moment, and Adam never
# moves them (m / sqrt(inf) = 0), nor what is behind them. Both packages agree
# on that gradient (tests/test_torch_ave_seed_init.py). Any other stall fails.
AVE_CLI_STALLS = frozenset({"audio_moe_p1_0", "audio_moe_p2_0"})
# The same two stall in the AVVP CLI, from its first Adam update on: while its
# expert gates are zero the stripes' blown-up gradients stay off the first
# site, once they are not they reach it and their square overflows
# (tests/test_torch_cli_seed_init.py; tools/cli_seed_init_grads.py).
AVVP_CLI_STALLS = AVE_CLI_STALLS


# TPAVI's W_z conv kernel and bias and its BN scale start at zero (flax's
# initializers, both packages): W_z's output is zero whatever its input, so
# neither W_z nor the g, theta and phi products before it get a gradient
TPAVI_W_Z_STALLS = r"^tpavi_b\d+\.((g|theta|phi|W_z_conv)\.|W_z_bn\.weight$)"


def avs_seed_init_stalls(cfg, names) -> set:
    """The trainable tensors of an AVS model that no step moves from the
    seeded init. TPAVI's W_z_conv kernel and bias and W_z_bn's scale start at
    zero (flax's initializers, in both packages), so W_z's output is zero
    whatever its input: W_z_bn's scale sees a normalized input of zeros,
    W_z_conv and the g, theta and phi products before it a zero scale, and
    none of them gets a gradient while all stay zero. Where the masked
    audio-visual loss is off (S4), the aligned audio and the temporal
    attention's video branch, which only scales that audio, get none either
    (tests/test_torch_avs_seed_init.py shows both on the CPU, in both
    packages)."""
    dead = TPAVI_W_Z_STALLS
    if not cfg.sa_loss_flag:
        dead += (r"|^tpavi_b\d+\.align_channel\.|^temporal_attn\."
                 r"(v_fc|visual_rnn|video_enc_affine|video_encoder|video_gated)_\d+\.")
    return {n for n in names if re.search(dead, n)}


def _stalled_adapters(state) -> set:
    """The adapters one of whose parameters (in AVE's case an expert gate)
    has a non-finite Adam second moment."""
    out = set()
    for n, q in state.trainable.items():
        if _adapter_of(n):
            v = state.optimizer.state[q].get("exp_avg_sq")
            if v is not None and not bool(torch.isfinite(v).all()):
                out.add(_adapter_of(n))
    return out


@contextlib.contextmanager
def _probed(mod, probe):
    names = probe.patch(mod)
    old = {k: getattr(mod, k) for k in names}
    for k, v in names.items():
        setattr(mod, k, v)
    try:
        yield probe
    finally:
        for k, v in old.items():
            setattr(mod, k, v)


def _cli_run(mod, argv, counters, **probe_kw):
    """`mod.main(argv)` under a `_CliProbe`, the kernels' counters zeroed just
    before: (main's result, the probe, the launches over the run, seconds)."""
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with _probed(mod, _CliProbe(**probe_kw)) as p:
        out = mod.main(argv)
    torch.cuda.synchronize()
    return out, p, {k: c.launches for k, c in counters.items()}, time.perf_counter() - t0


def _run_plan(per_step, per_eval, steps: int, evals: int) -> dict:
    return {k: steps * per_step[k] + evals * per_eval[k] for k in per_step}


def _frozen_unchanged(label: str, state, initial) -> int:
    """Every frozen parameter bit-identical to `initial` (the run's first
    step's copy); returns their count."""
    params = dict(state.model.named_parameters())
    frozen = [n for n, q in params.items() if not q.requires_grad]
    check(all(torch.equal(params[n], initial[n]) for n in frozen),
          f"{label}: a frozen parameter changed")
    return len(frozen)


def _moved(label: str, state, start, stalls=frozenset(), still=frozenset(),
           every: bool = True):
    """Every trainable parameter moved from `start` but for two kinds: those
    of the adapters in `stalls` whose Adam second moment overflowed
    (`_stalled_adapters`), and exactly the tensors of `still`, which must all
    stay unchanged; any other stall fails. Without `every` only the second
    holds: the tensors of `still` unchanged. Returns (moved tensors, the
    stalled adapters)."""
    stalled = _stalled_adapters(state)
    if stalled:
        log(f"[{label}] adapters with a non-finite Adam second moment: {sorted(stalled)}")
    check(stalled <= stalls, f"{label}: adapters stalled beyond the diagnosed {sorted(stalls)}: "
                             f"{sorted(stalled)}")
    unchanged = {n for n, q in state.trainable.items()
                 if torch.equal(q, start[n].to(q.device)) and _adapter_of(n) not in stalled}
    check(unchanged == set(still) if every else unchanged >= set(still),
          f"{label}: trainable parameters unchanged: {sorted(unchanged - set(still))[:5]}; of "
          f"the {len(still)} that cannot move, moved: {sorted(set(still) - unchanged)[:5]}")
    return sum(_adapter_of(n) not in stalled and n not in unchanged
               for n in state.trainable), stalled


def _loop_step_ms(starts, steps_per_epoch: int) -> float:
    """Median wall between consecutive step starts inside an epoch; each
    epoch's first step is left out (it waits for the loader's first batch)."""
    wall = [b - a for s0 in range(0, len(starts), steps_per_epoch)
            for a, b in zip(starts[s0 + 1: s0 + steps_per_epoch],
                            starts[s0 + 2: s0 + steps_per_epoch])]
    return float(np.median(wall)) * 1e3


def _expert_dumps(label: str, directory: str, sites: int) -> None:
    """The 12 expert_stats_*.npy files, each mean_gating_probs row summing to 1."""
    for key in GATING:
        files = [f"expert_stats_{key}_{s}.npy" for s in
                 ("activation_counts", "activation_fraction", "mean_gating_probs")]
        check(all(os.path.exists(os.path.join(directory, n)) for n in files),
              f"{label}: {key} telemetry files missing")
        probs = np.load(os.path.join(directory, files[2]))
        check(probs.shape[0] == sites and bool((np.abs(probs.sum(-1) - 1.0) <= 1e-3).all()),
              f"{label}: {key} mean gating probs {probs}")


def _memory_left_mib(base_mem: int) -> float:
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return (torch.cuda.memory_allocated() - base_mem) / 2**20


def _best_json(directory: str):
    from avmoe_tpu_torch.checkpoint.manager import CheckpointManager

    with open(os.path.join(directory, "best.json")) as f:
        best = json.load(f)
    return best, CheckpointManager(directory).all_steps()


def phase_ave_cli(train_step_ms: float):
    """`avmoe_tpu_torch.cli.train_ave.main` in-process on the full AVEConfig()
    in bf16, three times, each under a process group of world size 1 on
    NCCL (the gradient all-reduce runs at every step): train (1 epoch of
    32 synthetic clips, batch 4, accum 2: 8 micro-steps and 4 Adam updates,
    2 eval batches), --mode test on its checkpoint, --resume for a second
    epoch (which holds the step decay's learning rate)."""
    import shutil
    import tempfile

    from avmoe_tpu_torch.checkpoint.manager import CheckpointManager
    from avmoe_tpu_torch.cli import train_ave
    from avmoe_tpu_torch.config import AVEConfig
    from avmoe_tpu_torch.moe.injection import backward_launches, kernel_launches
    from avmoe_tpu_torch.parallel import mesh
    from avmoe_tpu_torch.parallel.dryrun import single_rank_env

    cfg = AVEConfig()
    lr, decay = 5e-4, 0.35
    tmp = tempfile.mkdtemp(prefix="ave_cli_")
    argv = ["--synthetic", "--batch_size", str(BATCH), "--accum_itr", "2", "--decay_epoch", "1",
            "--num_workers", "4", "--lr", str(lr), "--decay", str(decay),
            "--model_save_dir", tmp]
    counters = _train_counters()
    fwd = kernel_launches(cfg.swin, cfg.htsat, cfg.injection, block_chains=False)
    bwd = backward_launches(cfg.swin, cfg.htsat, cfg.injection)
    per_step = {"K1": fwd["K1"], "K2": fwd["K2"], **bwd}
    per_eval = {"K1": fwd["K1"], "K2": fwd["K2"], "K1b": 0, "K2b": 0}
    try:
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reduces = mesh.GRAD_ALLREDUCES
        with single_rank_env():
            best, p, got, train_s = _cli_run(train_ave, argv + ["--epochs", "1"], counters)
        check(not mesh.data_parallel(), "ave cli: the process group outlived main")
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps, evals = len(p.losses), len(p.evals)
        train_evals = [{k: v.cpu() for k, v in e.items()} for e in p.evals]
        check(steps == 8 and evals == 2, f"ave cli: {steps} train steps, {evals} eval batches")
        check(mesh.GRAD_ALLREDUCES - reduces == steps, f"ave cli: "
              f"{mesh.GRAD_ALLREDUCES - reduces} gradient all-reduces over {steps} steps")
        want = _run_plan(per_step, per_eval, steps, evals)
        check(got == want, f"ave cli: launches over the run {got}, want {want}")
        losses = [float(v) for v in p.losses]
        check(all(math.isfinite(v) for v in losses), f"ave cli: losses {losses}")
        check([len(x) for x in p.update_lrs] == [1] * 4, f"ave cli: lr groups {p.update_lrs}")
        lrs = [x[0] for x in p.update_lrs]
        check(all(math.isclose(v, lr, rel_tol=1e-12) for v in lrs),
              f"ave cli: learning rates of the updates {lrs}, want 4 x {lr}")
        n_frozen = _frozen_unchanged("ave cli", p.state, p.initial)
        n_moved, stalled = _moved("ave cli", p.state, p.initial, AVE_CLI_STALLS)
        n_stalled = len(p.state.trainable) - n_moved
        del p.state, p.initial, p.evals
        best_json, kept = _best_json(tmp)
        check(best_json["metric"] == best and best_json["step"] in kept and 1 <= len(kept) <= 3,
              f"ave cli: best.json {best_json}, steps kept {kept}")
        _expert_dumps("ave cli", tmp, 8)
        check("jax" not in sys.modules, "ave cli: jax was imported")
        step_wall_ms = _loop_step_ms(p.step_starts, 8)
        wait_ms = float(np.mean(p.waits)) * 1e3
        save_s, size = p.saves[-1]
        left = _memory_left_mib(base_mem)
        check(left < 64, f"ave cli: {left:.1f} MiB still allocated after main returned")
        log(f"[ave cli] train: AVEConfig() bf16, {steps} micro-steps (accum 2), {evals} eval "
            f"batches in {train_s:.1f} s; losses {[round(v, 4) for v in losses]}; update lrs "
            f"{lrs}; best {best} at step {best_json['step']}, steps kept {kept}; {n_frozen} "
            f"frozen tensors bit-identical, {n_moved} trainable tensors moved, "
            f"{n_stalled} in adapters whose gate's Adam second moment overflowed "
            f"({sorted(stalled)}); launches "
            f"{got} (plan {want}); {left:.1f} MiB left after main returned")
        train_got = got

        with single_rank_env():
            acc, q, got, test_s = _cli_run(train_ave, argv + ["--mode", "test"], counters)
        check(len(q.evals) == 2 and got == _run_plan(per_step, per_eval, 0, 2),
              f"ave cli test: {len(q.evals)} eval batches, launches {got}")
        check(acc == best_json["metric"], f"ave cli test: accuracy {acc} vs best.json "
              f"{best_json['metric']}")
        # test mode restores the latest step, which is the best (saves happen
        # only on improvement): its per-batch accuracies and expert gating
        # probabilities must equal those of that step's evaluation in the
        # train run, bit for bit
        check(kept[-1] == best_json["step"], f"ave cli test: latest step {kept[-1]} is not "
                                             f"best.json's {best_json['step']}")
        epoch = best_json["step"] // steps
        ref = train_evals[2 * (epoch - 1): 2 * epoch]
        differ = [f"batch {i} {k}" for i, (a, b) in enumerate(zip(ref, q.evals))
                  for k in a.keys() | b.keys()
                  if k not in a or k not in b or not torch.equal(a[k], b[k].cpu())]
        check(not differ, f"ave cli test: eval outputs differ from epoch {epoch}'s evaluation "
                          f"in the train run: {differ}")
        n_compared = sum(len(a) for a in ref)
        del q.evals
        log(f"[ave cli] test: accuracy {acc} == best.json's {best_json['metric']}; the restored "
            f"step {kept[-1]}'s {n_compared} per-batch accuracies and gating-probability stacks "
            f"bit-identical to epoch {epoch}'s evaluation in the train run, in {test_s:.1f} s; "
            f"launches {got}")

        saved = _saved_payload(CheckpointManager(tmp))
        reduces = mesh.GRAD_ALLREDUCES
        with single_rank_env():
            _, r, _, _ = _cli_run(train_ave, argv + ["--resume", "--epochs", "2"], counters,
                                  resume_from=saved)
        del saved
        restore_s = r.restores[-1]
        check(r.resume_diff == [], f"ave cli resume: restored state differs from the saved "
                                   f"one: {r.resume_diff}")
        losses2 = [float(v) for v in r.losses]
        check(len(losses2) == 8 and all(math.isfinite(v) for v in losses2)
              and mesh.GRAD_ALLREDUCES - reduces == 8,
              f"ave cli resume: second epoch's losses {losses2}, "
              f"{mesh.GRAD_ALLREDUCES - reduces} gradient all-reduces")
        lrs2 = [x[0] for x in r.update_lrs]
        check(len(lrs2) == 4 and all(math.isclose(v, lr * decay, rel_tol=1e-12) for v in lrs2),
              f"ave cli resume: learning rates of the updates {lrs2}, want 4 x {lr * decay}")
        lrs += lrs2
        log(f"[ave cli] resume: state bit-identical to step {kept[-1]}'s checkpoint (weights, "
            f"BN stats, Adam moments, acc_grads, step, updates); epoch 2 losses "
            f"{[round(v, 4) for v in losses2]}, update lrs {lrs2} (the step decay); each run "
            f"under an NCCL process group of world size 1, the gradient all-reduced every step")
        log(f"[time] ave cli: median loop step wall {step_wall_ms:.2f} ms (phase_train's step "
            f"{train_step_ms:.2f} ms); loader wait {wait_ms:.3f} ms a step; checkpoint "
            f"{size / 1e9:.3f} GB saved in {save_s * 1e3:.1f} ms, restored in "
            f"{restore_s * 1e3:.1f} ms; peak memory {peak:.2f} GiB")
        return {"clips": BATCH, "accum_steps": 2, "train_steps": steps, "eval_batches": evals,
                "loop_step_wall_ms": step_wall_ms, "phase_train_step_ms": train_step_ms,
                "loader_wait_ms_per_step": wait_ms, "checkpoint_gb": size / 1e9,
                "checkpoint_save_ms": save_s * 1e3, "checkpoint_restore_ms": restore_s * 1e3,
                "peak_gib": peak, "train_run_s": train_s, "test_run_s": test_s,
                "best_val_accuracy": best, "test_accuracy": acc, "launches": train_got,
                "stalled_adapters": sorted(stalled)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# AVE's legacy models: MMIL_Net v1 (DG-SCT adapters) and the LAVisH
# MMIL_Net_v2 (one Swin-V2 for both streams)
# ---------------------------------------------------------------------------

LEGACY = {"v1": "MMILNetV1", "lavish": "MMILNetV2"}
# The adapters that may stall at the legacy CLIs' seeded init (as
# AVE_CLI_STALLS): none is diagnosed, so any stall fails.
LEGACY_CLI_STALLS = {"v1": frozenset(), "lavish": frozenset()}


@contextlib.contextmanager
def _kernel_shapes():
    """The distinct (kernel, shape, dtype) of every K1, K2, K1b and K2b call
    inside the block: K1 and K2 as ops/swin.py calls them, K1b and K2b as
    their autograd Functions do. The wrappers still count their launches."""
    import avmoe_tpu_torch.kernels.mlp_block as mb
    import avmoe_tpu_torch.kernels.window_attention as wa
    import avmoe_tpu_torch.ops.swin as swin

    seen = set()

    def k1(q, k, v, bias, *a, **kw):
        return ("K1", (q.shape[0], q.shape[1], q.shape[2], q.shape[3], bias.shape[0]))

    def k2(x, *a, pre_norm, **kw):
        return ("K2", (x.numel() // x.shape[-1], x.shape[-1], pre_norm))

    def k1b(q, *a, **kw):
        return ("K1b", k1(q, *a)[1])

    def k2b(dy, *a, pre_norm, **kw):
        return ("K2b", k2(dy, pre_norm=pre_norm)[1])

    class Recorded:
        """The wrapper `fn`, recording each call's shape; its `launches`
        are the wrapper's own."""

        def __init__(self, fn, key):
            object.__setattr__(self, "fn", fn)
            object.__setattr__(self, "key", key)

        def __call__(self, *a, **kw):
            kind, shape = self.key(*a, **kw)
            seen.add((kind, shape, str(a[0].dtype).replace("torch.", "")))
            return self.fn(*a, **kw)

        def __getattr__(self, name):
            return getattr(self.fn, name)

        def __setattr__(self, name, value):
            setattr(self.fn, name, value)

    sites = ((swin, "window_attention", k1), (swin, "mlp_block", k2),
             (wa, "window_attention_bwd", k1b), (mb, "mlp_block_bwd", k2b))
    kept = [getattr(mod, name) for mod, name, _ in sites]
    for (mod, name, key), fn in zip(sites, kept):
        setattr(mod, name, Recorded(fn, key))
    try:
        yield seen
    finally:
        for (mod, name, _), fn in zip(sites, kept):
            setattr(mod, name, fn)


def _checked_shapes(frames: int):
    """{kernel: the shapes phases 3, 4, 10 and 11 hold against the plain
    versions at `frames` frames}, each in float32 and bfloat16."""
    return {"K1": {s[:-1] for s in k1_shapes(frames)}, "K2": {s[:-1] for s in k2_shapes(frames)},
            "K1b": {s[:-1] for s in k1b_shapes(frames)},
            "K2b": {s[:-1] for s in k2b_shapes(frames)}}


def phase_legacy_shapes(gen, seen, label: str):
    """Every kernel shape a legacy model's run gave the wrappers is one the
    AVE phases hold against the plain versions (at 10 * BATCH frames); a
    shape of another frame count is held here by that kernel's phase at its
    frames. Returns the distinct shapes seen."""
    runs = {"K1": phase_k1, "K2": phase_k2, "K1b": phase_k1b, "K2b": phase_k2b}
    checked = _checked_shapes(BATCH * 10)
    out = []
    for kind, shape, dtype in sorted(seen):
        check(dtype in ("float32", "bfloat16"), f"{label}: {kind} at {shape} in {dtype}")
        if shape in checked[kind]:
            continue
        frames = next((f for f in range(1, 8 * BATCH * 10 + 1)
                       if shape in _checked_shapes(f)[kind]), None)
        check(frames is not None, f"{label}: {kind} shape {shape} is on no plan")
        out.append((kind, frames))
    for kind, frames in sorted(set(out)):
        runs[kind](gen, frames, f"{label} {kind} at {frames} frames")
    log(f"[{label}] {len(seen)} distinct kernel shapes: "
        + ", ".join(f"{k} {sum(s[0] == k for s in seen)}" for k in runs)
        + (f"; held here at other frame counts: {sorted(set(out))}" if out else
           f"; all held by phases 3, 4, 10 and 11 at {BATCH * 10} frames"))
    return len(seen)


def _legacy_inputs(cfg, name: str, seed: int):
    """(audio input, frames) of a batch-BATCH eval: the waveform (v1) or
    fbank images at the normalized spectrogram's scale (lavish)."""
    wave, imgs = _inputs(cfg, BATCH, seed, "cuda")
    if name == "v1":
        return wave, imgs
    g = torch.Generator(device="cuda").manual_seed(seed)
    S = cfg.swin.img_size
    return 0.5 * torch.randn(BATCH, cfg.num_segments, S, S, generator=g, device="cuda"), imgs


def _legacy_outputs(name: str, out) -> torch.Tensor:
    keys = ("is_event_logits", "event_logits") if name == "v1" else ("event_logits",)
    return torch.cat([out[k].float().flatten() for k in keys])


def _token_projection_ms(model, a, imgs):
    """Device time of MMIL_Net v1's 48 token projections (`moe/adapter.py`
    `project_tokens`, the library products of the DG-SCT adapters) at one
    batch-BATCH forward's inputs: forward alone and forward + backward (the
    gradients of the stream and of the trainable kernels and biases), the
    sum of the kernels' device times in one profiled run of all 48 after a
    dropped warm-up (CUDA events would also count the device's idle gaps
    between these short launches). Returns (forward ms, forward + backward
    ms, GFLOP of the forward products)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    import avmoe_tpu_torch.moe.dgsct_adapter as dg

    calls = []
    inner = dg.project_tokens
    dg.project_tokens = lambda *args: (calls.append(args), inner(*args))[1]
    try:
        model(a, imgs)
    finally:
        dg.project_tokens = inner
    flops = 0.0
    for other, tk, _, fk, _ in calls:
        B, M, Co = other.shape
        N, C = tk.shape[0], fk.shape[1]
        flops += 2.0 * B * (N * M * Co + N * Co * C if C >= Co else M * Co * C + N * M * C)

    def fwd():
        for args in calls:
            inner(*args)

    leaves = [(other.detach().requires_grad_(), tk.detach().requires_grad_(), tb.detach()
               .requires_grad_(), fk.detach().requires_grad_(), fb.detach().requires_grad_())
              for other, tk, tb, fk, fb in calls]

    def both():
        for args in leaves:
            out = inner(*args)
            torch.autograd.grad(out, args, torch.ones_like(out))

    times = []
    for run in (fwd, both):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1), acc_events=True) as prof:
            for _ in range(2):
                run()
                torch.cuda.synchronize()
                prof.step()
        times.append(sum(_device_ms_by_name(prof).values()))
    return times[0], times[1], flops / 1e9


def phase_legacy(name: str, gen):
    """A legacy AVE model at full width (AVEConfig()) in bf16 at batch BATCH,
    seeded weights with noised gates and gate_av: the eval forward's
    launches as planned, shapes, finiteness, the bf16-vs-fp32 cosine of its
    logits (and LAVisH's probabilities) >= 0.99, its wall time; three train
    steps with the recipe's draws (v1: DropPath, SpecAugment, mixup; lavish:
    DropPath): launches as planned, frozen weights bit-identical, every
    trainable tensor and the adapters' running stats moved (and v1's bn0);
    the step's time and peak memory, v1's profile; every kernel shape of
    both runs held against the plain versions; v1's token projections timed
    alone. v1 trains from the eval's noised gates; LAVisH, whose gradient
    explodes there in both packages, from the seeded init. Returns the
    numbers."""
    import avmoe_tpu_torch.models.ave_legacy as al
    from avmoe_tpu_torch.config import AVEConfig, TrainConfig
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    cfg, v = AVEConfig(), "1" if name == "v1" else "2"
    Model = getattr(al, LEGACY[name])
    fwd = getattr(al, f"mmil_v{v}_kernel_launches")(cfg)
    bwd = getattr(al, f"mmil_v{v}_backward_launches")(cfg)
    t0 = time.perf_counter()
    model = Model(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    _nonzero_gates_(model, 1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    a, imgs = _legacy_inputs(cfg, name, 3)
    counters = _counters()
    with _kernel_shapes() as seen:
        for c in counters.values():
            c.launches = 0
        out = model(a, imgs)
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        check(got == fwd, f"{name}: launches per forward {got}, want {fwd}")
        T, C = cfg.num_segments, cfg.num_classes
        want = ({"is_event_logits": (BATCH, T), "event_logits": (BATCH, C),
                 "av_score": (BATCH, C), "av_gate": (BATCH, T)} if name == "v1"
                else {"event_probs": (BATCH * T, C + 1), "event_logits": (BATCH * T, C + 1)})
        for key, shape in want.items():
            check(tuple(out[key].shape) == shape and bool(torch.isfinite(out[key]).all()),
                  f"{name}: {key} {tuple(out[key].shape)} (want {shape}) not finite or shaped")
        if name == "lavish":
            check(bool(((out["event_probs"].sum(-1) - 1).abs() <= 1e-3).all()),
                  "lavish: event_probs rows do not sum to 1")
        f32 = Model(cfg, dtype=torch.float32, device="cuda", seed=None)
        f32.load_state_dict(model.state_dict())
        ref = f32(a, imgs)
        cos = {"logits": F.cosine_similarity(_legacy_outputs(name, out),
                                             _legacy_outputs(name, ref), dim=0).item()}
        if name == "lavish":
            cos["probs"] = F.cosine_similarity(out["event_probs"].flatten(),
                                               ref["event_probs"].flatten(), dim=0).item()
        del f32, ref
        torch.cuda.empty_cache()
        check(min(cos.values()) >= 0.99, f"{name}: bf16 vs fp32 cosines {cos} < 0.99")
        log(f"[{name}] AVEConfig() bf16 batch {BATCH}, built in {build_s:.1f} s: launches per "
            f"forward {got} (plan {fwd}), shapes ok, finite; bf16 vs fp32 cosines "
            + ", ".join(f"{k} {c:.6f}" for k, c in cos.items()) + " (>= 0.99)")
        fwd_ms = _times(model, f"{name} default path", a, imgs, batch1=False)
        proj = _token_projection_ms(model, a, imgs) if name == "v1" else None

        batch = _train_batches(cfg, BATCH, 1, 11, "cuda")[0]
        batch.pop("mixup_lambda")               # v1: λ drawn per frame from Beta(0.5, 0.5)
        if name == "lavish":
            batch["audio_spec"] = _legacy_inputs(cfg, name, 4)[0]
            batch.pop("wave")
            # from the noised gates LAVisH's gradient explodes through stage
            # 2, in both packages (tools/lavish_grad_conditioning.py; on the
            # card tools/legacy_grad_diagnosis.py): it trains from where
            # training starts, the seeded init
            model = Model(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
        state = create_train_state(model, TrainConfig(accum_steps=1), steps_per_epoch=100)
        loss_fn = (al.make_mmil_v1_loss_fn(model, mixup_alpha=0.5) if name == "v1"
                   else al.make_mmil_v2_loss_fn(model))
        step = make_train_step(loss_fn)
        want = {"K1": fwd["K1"], "K2": fwd["K2"], **bwd}
        g = torch.Generator(device="cuda").manual_seed(12)
        got_s, losses, n_frozen, n_moved = _checked_steps(
            f"{name} train", model, state, step, batch, g, want,
            ("bn0", "adapter") if name == "v1" else ("adapter",))
    log(f"[{name}] train steps bf16 batch {BATCH}, DropPath" + (
        " + SpecAugment + mixup, gates noised" if name == "v1" else ", the seeded init") +
        f": losses "
        f"{[round(x, 5) for x in losses]}; {n_frozen} frozen tensors bit-identical, {n_moved} "
        f"trainable tensors moved, running stats moved; launches per step {got_s} (plan {want})")
    step_ms, peak, prof = _step_times(f"{name} train step", step, state, batch, g)
    n_shapes = phase_legacy_shapes(gen, seen, name)
    res = {"clips": BATCH, "build_s": build_s, "eval_ms": fwd_ms,
           "eval_clips_per_s": BATCH / fwd_ms * 1e3, "bf16_vs_f32_cosines": cos,
           "launches_per_forward": got, "launches_per_step": got_s, "train_losses": losses,
           "train_step_ms": step_ms, "train_clips_per_s": BATCH / step_ms * 1e3,
           "train_peak_gib": peak, "train_device_busy_ms": prof[0],
           "train_idle_share": prof[1], "train_idle_share_profiled": prof[2],
           "distinct_kernel_shapes": n_shapes}
    if proj is not None:
        fwd_p, both_p, gflop = proj
        res.update(token_projection_fwd_ms=fwd_p, token_projection_fwd_bwd_ms=both_p,
                   token_projection_gflop=gflop,
                   token_projection_share_of_eval_wall=fwd_p / fwd_ms,
                   token_projection_share_of_step_device_busy=(
                       None if prof[0] is None else both_p / prof[0]))
        log(f"[v1] token projections (48 a forward, {gflop:.1f} GFLOP): {fwd_p:.3f} ms forward "
            f"({fwd_p / fwd_ms:.3f} of the eval forward's wall), {both_p:.3f} ms forward + "
            f"backward" + ("" if prof[0] is None else
                           f" ({both_p / prof[0]:.3f} of the train step's device busy)"))
    del model, state, step
    torch.cuda.empty_cache()
    return res


def phase_legacy_cli(name: str, train_step_ms: float):
    """`avmoe_tpu_torch.cli.train_ave.main --model v1|lavish` in-process on
    the full AVEConfig() in bf16, three times: train one epoch (32 synthetic
    clips, batch 4, accum 1: 8 micro-steps and updates, 2 eval batches),
    --mode test on its checkpoint (the per-batch accuracies of that epoch's
    evaluation, bit for bit), --resume for a second epoch (the restored
    state bit-identical; every trainable tensor moved over the two runs but
    the diagnosed stalls, LEGACY_CLI_STALLS)."""
    import shutil
    import tempfile

    import avmoe_tpu_torch.models.ave_legacy as al
    from avmoe_tpu_torch.cli import train_ave
    from avmoe_tpu_torch.config import AVEConfig

    cfg, spe, label = AVEConfig(), 8, f"{name} cli"
    v = "1" if name == "v1" else "2"
    tmp = tempfile.mkdtemp(prefix=f"{name}_cli_")
    argv = ["--model", name, "--synthetic", "--batch_size", str(BATCH), "--accum_itr", "1",
            "--num_workers", "4", "--model_save_dir", tmp]
    counters = _train_counters()
    fwd = getattr(al, f"mmil_v{v}_kernel_launches")(cfg)
    per_step = {"K1": fwd["K1"], "K2": fwd["K2"], **getattr(al, f"mmil_v{v}_backward_launches")(
        cfg)}
    per_eval = {"K1": fwd["K1"], "K2": fwd["K2"], "K1b": 0, "K2b": 0}
    try:
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        best, p, got, train_s = _cli_run(train_ave, argv + ["--epochs", "1"], counters)
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps, evals = len(p.losses), len(p.evals)
        check(steps == spe and evals == 2, f"{label}: {steps} train steps, {evals} eval batches")
        train_evals = [{k: t.cpu() for k, t in e.items()} for e in p.evals]
        res, start = _cli_train_report(label, p, got, _run_plan(per_step, per_eval, steps, evals),
                                       spe, base_mem, moved=False)
        best_json, kept = _best_json(tmp)
        check(best_json == {"step": spe, "metric": best} and kept == [spe],
              f"{label}: best.json {best_json}, best {best}, steps kept {kept}")
        log(f"[{label}] train: AVEConfig() bf16, {steps} micro-steps and updates, {evals} eval "
            f"batches in {train_s:.1f} s; losses {[round(x, 4) for x in res['losses']]}; "
            f"best.json {best_json}; {res['frozen_tensors']} frozen tensors bit-identical; "
            f"launches {got}")

        acc, q, got_t, test_s = _cli_run(train_ave, argv + ["--mode", "test"], counters)
        check(got_t == _run_plan(per_step, per_eval, 0, 2) and acc == best_json["metric"],
              f"{label} test: launches {got_t}, accuracy {acc} vs best.json {best_json}")
        differ = [f"batch {i} {k}" for i, (x, y) in enumerate(zip(train_evals, q.evals))
                  for k in x.keys() | y.keys()
                  if k not in x or k not in y or not torch.equal(x[k], y[k].cpu())]
        check(len(q.evals) == 2 and not differ,
              f"{label} test: eval outputs differ from the train run's evaluation: {differ}")
        log(f"[{label}] test: accuracy {acc} == best.json's; the per-batch accuracies "
            f"bit-identical to epoch 1's evaluation in the train run, in {test_s:.1f} s")
        losses2, restore_ms, n_moved = _cli_resume(
            label, train_ave, argv + ["--resume", "--epochs", "2"], counters, tmp, spe, 2,
            start=start, stalls=LEGACY_CLI_STALLS[name])
        log(f"[time] {label}: median loop step wall {res['loop_step_wall_ms']:.2f} ms "
            f"(phase_legacy's step {train_step_ms:.2f} ms); loader wait "
            f"{res['loader_wait_ms_per_step']:.3f} ms a step; checkpoint "
            f"{res['checkpoint_gb']:.3f} GB saved in {res['checkpoint_save_ms']:.1f} ms, restored "
            f"in {restore_ms:.1f} ms; peak memory {peak:.2f} GiB")
        return {**res, "clips": BATCH, "accum_steps": 1, "train_steps": steps,
                "eval_batches": evals, "phase_train_step_ms": train_step_ms,
                "checkpoint_restore_ms": restore_ms, "peak_gib": peak, "train_run_s": train_s,
                "test_run_s": test_s, "best_val_accuracy": best, "test_accuracy": acc,
                "launches": got, "resume_losses": losses2, "moved_tensors": n_moved}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# AVVP: the MGN model (adapters in all four stages, bmm unimodal experts,
# grouping heads)
# ---------------------------------------------------------------------------

AVVP_OUT = ("aud_cls_logits", "vis_cls_logits", "global_prob", "a_prob", "v_prob",
            "a_frame_prob", "v_frame_prob")
GATING = ("audio_p1", "audio_p2", "video_p1", "video_p2")


def _avvp_inputs(cfg, clips: int, seed: int, device):
    """Seeded waves, frames and r2plus1d features (B, T, st_dim)."""
    wave, imgs = _inputs(cfg, clips, seed, device)
    st = np.random.RandomState(seed + 1).randn(clips, cfg.num_segments, cfg.st_dim)
    return wave, imgs, torch.from_numpy(st.astype(np.float32)).to(device)


def _avvp_batches(cfg, clips: int, steps: int, seed: int, device):
    """Seeded AVVP batches: inputs, weak (B, 25) labels, a per-frame mixup λ."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        wave, imgs, st = _avvp_inputs(cfg, clips, int(rng.randint(1 << 30)), device)
        labels = (rng.rand(clips, cfg.num_classes) < 0.2).astype(np.float32)
        lam = rng.uniform(0.3, 0.7, clips * cfg.num_segments).astype(np.float32)
        out.append(dict(wave=wave, images=imgs, video_st=st,
                        labels=torch.from_numpy(labels).to(device),
                        mixup_lambda=torch.from_numpy(lam).to(device)))
    return out


@contextlib.contextmanager
def _heads_without_draws(models, noise: torch.Tensor):
    """The heads' random draws made the same on the CPU and the card: their
    DropPath off and HAN's Gumbel noise given (`noise`, (B, T, T))."""
    import avmoe_tpu_torch.heads.grouping as grouping

    kept = grouping.gumbel_noise
    rates = [(m, m.drop_path) for model in models for m in model.modules()
             if isinstance(m, grouping.AttnBlock)]
    grouping.gumbel_noise = lambda shape, generator, device, dtype: noise.to(device, dtype)
    for m, _ in rates:
        m.drop_path = 0.0
    try:
        yield
    finally:
        grouping.gumbel_noise = kept
        for m, rate in rates:
            m.drop_path = rate


def _close_to_cpu(out, ref, keys, label: str, moved=None) -> float:
    """The outputs `keys`, the gating probs and lb_loss of a card forward
    against a CPU one, rtol 1e-3, atol 1e-4; the largest |d| of the outputs.
    With `moved`, the CPU outputs at inputs changed by 1e-6 relative: a
    tensor whose own change there is larger may differ by up to 4 times
    that change (a model that turns float32 rounding into more than the
    tolerance)."""
    worst = 0.0
    pairs = [(key, out[key], ref[key], None if moved is None else moved[key]) for key in keys]
    pairs += [(key, out["telemetry"][key], ref["telemetry"][key],
               None if moved is None else moved["telemetry"][key])
              for key in GATING + ("lb_loss",)]
    for key, a, b, m in pairs:
        d = (a.cpu() - b).abs()
        allowed = 1e-4 + 1e-3 * b.abs()
        if m is not None:
            allowed = torch.clamp(allowed, min=4.0 * (m - b).abs().max().item())
        if key in keys:
            worst = max(worst, d.max().item())
        check(bool((d <= allowed).all()), f"{label} {key}: card vs CPU max |d| "
              f"{d.max().item():.3e}" + ("" if m is None else
                                         f" (CPU's own move {(m - b).abs().max().item():.3e})"))
    return worst


# The (chain path, fused combine) routes of a tiny phase's eval forward: the
# fused combine on the default path only (the switch acts on the adapters,
# which both paths share)
TINY_ROUTES = ((False, False), (False, True), (True, False))


def _route_label(chains: bool, fused: bool) -> str:
    return ("chain path" if chains else "default path") + (", fused combine" if fused else "")


def phase_avvp_tiny() -> int:
    """Tiny MGNModel in float32: the eval forward on both paths and on the
    default path with the fused combine, one train step's gradients on both
    combines and a 2-step train curve on the default path, card (kernels)
    vs CPU (plain versions). Returns the K3 launches of the tiny chain-path
    forward."""
    from avmoe_tpu_torch.config import tiny_avvp_config
    from avmoe_tpu_torch.kernels.block_chain import block_chain
    from avmoe_tpu_torch.models.avvp import MGNModel, make_avvp_loss_fn

    cfg = tiny_avvp_config()
    tag = "avvp tiny"
    cpu = MGNModel(cfg, device="cpu", seed=0)
    _nonzero_gates_(cpu, 1)
    ins = _avvp_inputs(cfg, 2, 2, "cpu")
    chain_launches = 0
    for chains, fused in TINY_ROUTES:
        label = _route_label(chains, fused)
        cpu.encoder.block_chains = chains
        _set_fused_(cpu, fused, False)
        ref = cpu(*ins)
        gpu = MGNModel(cfg, device="cuda", seed=None, block_chains=chains)
        gpu.load_state_dict(cpu.state_dict())
        _set_fused_(gpu, fused, False)
        block_chain.launches = 0
        out = gpu(*(t.cuda() for t in ins))
        torch.cuda.synchronize()
        check((block_chain.launches > 0) == chains, f"tiny AVVP {label}: K3 launches "
              f"{block_chain.launches}")
        if chains:
            chain_launches = block_chain.launches
        worst = _close_to_cpu(out, ref, AVVP_OUT, f"{tag} {label}")
        log(f"[{tag}] fp32 {label}, card (kernels) vs CPU (plain): every output, gating "
            f"probs and lb_loss within rtol 1e-3, atol 1e-4; outputs max |d| {worst:.3e}")
    cpu.encoder.block_chains = False
    _set_fused_(cpu, False, False)

    gpu = MGNModel(cfg, device="cuda", seed=None)
    gpu.load_state_dict(cpu.state_dict())
    T = cfg.num_segments
    noise = torch.from_numpy(np.random.RandomState(3).gumbel(size=(2, T, T)).astype(np.float32))
    with _heads_without_draws((cpu, gpu), noise):
        _tiny_train_vs_cpu(tag, cpu, gpu, make_avvp_loss_fn,
                           lambda n, dev: _avvp_batches(cfg, 2, n, 7, dev), steps=2,
                           fused=True)
    return chain_launches


def _han_assignments(model, store: list):
    """Forward hook on HAN's assignment: the group each token's straight-
    through argmax picks, appended to `store` at every call."""
    assign = model.audio_cug.han_encoder.assign

    def hook(mod, args, output):
        q, k = mod.q_proj(args[0]), mod.k_proj(args[1])
        store.append(torch.einsum("bgc,btc->bgt", q, k).argmax(dim=-2).cpu())

    return assign.register_forward_hook(hook)


def phase_avvp_gram(gen):
    """The bmm expert's float32 logits x xᵀ of a bf16 x (one bf16 product
    accumulating in float32, `moe/adapter.py` `_gram_f32`) against the
    product of the upcast values, forward and backward, at each stage's
    (tokens, channels) for BATCH clips; times of both."""
    from avmoe_tpu_torch.config import AVVPConfig
    from avmoe_tpu_torch.moe.adapter import _gram_f32

    cfg = AVVPConfig()
    plain = lambda x: torch.matmul(x.float(), x.float().transpose(1, 2))
    rows = BATCH * cfg.num_segments
    shapes = []
    for s in range(4):
        shapes.append(("visual", cfg.swin.patches_resolution[0] ** 2 // 4 ** s,
                       cfg.swin.embed_dim * 2 ** s))
        shapes.append(("audio", (cfg.htsat.spec_size // cfg.htsat.patch_size) ** 2 // 4 ** s,
                       cfg.htsat.embed_dim * 2 ** s))
    for side, N, C in shapes:
        x = (torch.randn(rows, N, C, device="cuda", generator=gen) * 0.3).bfloat16()
        dz = torch.randn(rows, N, N, device="cuda", generator=gen)
        (out, (dx,)), (ref, (dref,)) = _grads(_gram_f32, [x], dz), _grads(plain, [x], dz)
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        derr = ((dx.float() - dref.float()).abs().max() / dref.float().abs().max()).item()
        check(out.dtype == torch.float32 and err <= 1e-5,
              f"bmm logits {side} N={N} C={C}: relative error {err:.3e} > 1e-5")
        check(derr <= 2 ** -7, f"bmm logits backward {side} N={N} C={C}: relative error "
              f"{derr:.3e} > 2^-7 (one bf16 step)")
        log(f"[gram] {side} ({rows}, {N}, {C}): forward {time_ms(lambda: _gram_f32(x)):.3f} ms "
            f"(upcast float32 product {time_ms(lambda: plain(x)):.3f} ms), backward "
            f"{_backward_ms(_gram_f32, [x], dz):.3f} ms (upcast "
            f"{_backward_ms(plain, [x], dz):.3f} ms); max relative error {err:.2e}, "
            f"backward {derr:.2e}")
        del x, dz, out, dx, ref, dref
    torch.cuda.empty_cache()


def phase_avvp_full():
    """AVVPConfig() in bfloat16 on the default path at batch 4 and 1 clips:
    launches, shapes, finiteness, gating sums; bf16 vs fp32 cosine of the
    pooled encoder features (gated) and the heads' differences (reported);
    the F1 suite through make_avvp_eval_fn; times and a profile."""
    from avmoe_tpu_torch.config import AVVPConfig
    from avmoe_tpu_torch.metrics.avvp import AVVPEvaluator
    from avmoe_tpu_torch.models.avvp import MGNModel, make_avvp_eval_fn
    from avmoe_tpu_torch.moe.injection import kernel_launches

    cfg = AVVPConfig()
    T = cfg.num_segments
    t0 = time.perf_counter()
    model = MGNModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    _nonzero_gates_(model, 1)
    torch.cuda.synchronize()
    sites = len(model.encoder.sites)
    log(f"[avvp] AVVPConfig() bf16 built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters())} parameters, {sites} adapter sites")
    ins = _avvp_inputs(cfg, BATCH, 3, "cuda")
    want = kernel_launches(cfg.swin, cfg.htsat, cfg.injection, block_chains=False)
    counters = _counters()
    for clips in (BATCH, 1):
        for c in counters.values():
            c.launches = 0
        out = model(*(t[:clips] for t in ins))
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        check(got == want, f"AVVP batch {clips}: launches per forward {got}, want {want}")
        shapes = {"aud_cls_logits": (25, 25), "vis_cls_logits": (25, 25),
                  "global_prob": (clips, 25), "a_prob": (clips, 25), "v_prob": (clips, 25),
                  "a_frame_prob": (clips, T, 25), "v_frame_prob": (clips, T, 25)}
        for key, shape in shapes.items():
            check(tuple(out[key].shape) == shape, f"AVVP {key} shape {tuple(out[key].shape)}")
            check(bool(torch.isfinite(out[key]).all()), f"AVVP batch {clips}: {key} not finite")
        for key in GATING:
            p = out["telemetry"][key]
            check(tuple(p.shape) == (sites, clips * T, 2), f"AVVP {key} shape {tuple(p.shape)}")
            check(bool(((p.sum(-1) - 1.0).abs() <= 1e-3).all()), f"AVVP {key} sums")
        lb = float(out["telemetry"]["lb_loss"])
        # -sum(log mean p) over 2 experts is >= 2 log 2 per call, 4 calls a site
        check(math.isfinite(lb) and lb >= 4 * sites * 2 * math.log(2) - 1e-2,
              f"AVVP lb_loss {lb}")
        if clips == BATCH:
            launches = got
        log(f"[avvp] default path batch {clips}: shapes ok, finite, gating sums ok, lb_loss "
            f"{lb:.4f}, launches " + " ".join(f"{k} {v}" for k, v in got.items()))

    f32 = MGNModel(cfg, dtype=torch.float32, device="cuda", seed=None)
    f32.load_state_dict(model.state_dict())
    frames = (ins[0].reshape(BATCH * T, -1), ins[1].reshape((BATCH * T,) + tuple(ins[1].shape[2:])))
    with torch.no_grad():
        (fv16, fa16, _), (fv32, fa32, _) = model.encoder(*frames), f32.encoder(*frames)
    cos = {name: F.cosine_similarity(a.float().flatten(), b.flatten(), dim=0).item()
           for name, a, b in (("f_v", fv16, fv32), ("f_a", fa16, fa32))}
    del fv16, fa16, fv32, fa32
    check(all(c >= 0.99 for c in cos.values()), f"AVVP bf16 vs fp32 pooled features {cos}")
    han = {16: [], 32: []}
    hooks = [_han_assignments(model, han[16]), _han_assignments(f32, han[32])]
    out16, out32 = model(*ins), f32(*ins)
    for h in hooks:
        h.remove()
    head_d = {k: (out16[k].float() - out32[k]).abs().max().item() for k in AVVP_OUT}
    flips = int((han[16][0] != han[32][0]).sum())
    log(f"[avvp] bf16 vs fp32: pooled encoder features cosine f_v {cos['f_v']:.6f}, f_a "
        f"{cos['f_a']:.6f} (>= 0.99); reported, not gated: heads' max |d| "
        + ", ".join(f"{k} {v:.3e}" for k, v in head_d.items())
        + f"; HAN's straight-through assignments flipped {flips} of {han[16][0].numel()}")
    del f32, out16, out32
    torch.cuda.empty_cache()

    rng = np.random.RandomState(5)
    gt_a = {i: (rng.rand(25, T) < 0.3).astype(np.int64) for i in range(BATCH)}
    gt_v = {i: (rng.rand(25, T) < 0.3).astype(np.int64) for i in range(BATCH)}
    ev = AVVPEvaluator()
    make_avvp_eval_fn(model, gt_a, gt_v)(
        dict(wave=ins[0], images=ins[1], video_st=ins[2], clip_index=torch.arange(BATCH)), ev)
    summary = ev.summary()
    check(len(summary) == 10 and all(math.isfinite(v) for v in summary.values()),
          f"AVVP F1 summary {summary}")
    log("[avvp] F1 suite of the batch-4 eval outputs against seeded ground truth: "
        + ", ".join(f"{k} {v:.2f}" for k, v in summary.items()))

    fwd_ms = _times(model, "AVVP default path", *ins)
    prof = phase_profile("AVVP default path", lambda: model(*ins), fwd_ms)
    return launches, fwd_ms, prof, model


def _full_grad_gate(tag: str, make_model, loss_fn, batch,
                    frozen_scopes=("swin", "htsat")) -> None:
    """The gradient gate of a full-width train step: one deterministic
    step's trainable gradients in float32 through the kernels against float32
    through their plain versions, the same generator seed for both, at the
    seeded init (gates zero; checked: cosine >= 0.9999 overall and on every
    leaf); bf16 against float32 there (reported). (With the trained model's
    noised gates the float32 gradient moves with the rounding, so nothing
    is read there.) `make_model(dtype, seed)`
    builds the model on the card; `frozen_scopes` the backbones that stay
    frozen."""
    from avmoe_tpu_torch.train.freeze import freeze

    plain = _plain_cores()
    src = make_model(torch.bfloat16, 0)
    f32 = make_model(torch.float32, None)
    f32.load_state_dict(src.state_dict())
    freeze(f32, frozen_scopes)
    freeze(src, frozen_scopes)
    ref = _trainable_grads(f32, loss_fn, batch, 13)
    read = {"f32 plain / f32": _grad_cosines(
                _trainable_grads(f32, loss_fn, batch, 13, cores=plain), ref),
            "bf16 / f32": _grad_cosines(_trainable_grads(src, loss_fn, batch, 13), ref)}
    del src, f32, ref
    torch.cuda.empty_cache()
    log(f"[{tag}] trainable gradients of one deterministic step, seeded init: " + "; ".join(
        f"{k} cosine {w:.7f}, lowest leaf {lo:.7f} ({leaf})" for k, (w, lo, leaf) in read.items()))
    whole, low, leaf = read["f32 plain / f32"]
    check(whole >= 0.9999 and low >= 0.9999, f"{tag}: fp32 gradients through the kernels vs "
          f"their plain versions at the seeded init: cosine {whole:.7f}, leaf {leaf} {low:.7f}; "
          f"want >= 0.9999")


def phase_avvp_train(model):
    """The full AVVPConfig() train step in bf16 on the default path at batch
    BATCH, DropPath, SpecAugment, dropout, HAN's Gumbel noise and mixup on;
    then the fp32 gradient gate; times, peak memory and a profile."""
    from avmoe_tpu_torch.config import AVVPConfig, TrainConfig
    from avmoe_tpu_torch.models.avvp import MGNModel, make_avvp_loss_fn
    from avmoe_tpu_torch.moe.injection import backward_launches, kernel_launches
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    cfg = AVVPConfig()
    lr = TrainConfig().lr
    state = create_train_state(model, TrainConfig(accum_steps=1, lr=lr, lr_mlp=lr),
                               steps_per_epoch=100)
    loss_fn = make_avvp_loss_fn(model)
    step = make_train_step(loss_fn)
    batch = _avvp_batches(cfg, BATCH, 1, 11, "cuda")[0]
    lam = batch.pop("mixup_lambda")             # λ drawn per frame from Beta(0.5, 0.5)
    fwd = kernel_launches(cfg.swin, cfg.htsat, cfg.injection, block_chains=False)
    want = {"K1": fwd["K1"], "K2": fwd["K2"], **backward_launches(cfg.swin, cfg.htsat,
                                                                   cfg.injection)}
    gen = torch.Generator(device="cuda").manual_seed(12)
    torch.cuda.reset_peak_memory_stats()
    # the adapters have no BatchNorm: bn0's are the running stats
    got, losses, n_frozen, n_moved = _checked_steps("AVVP train", model, state, step, batch,
                                                    gen, want, ("bn0",))
    log(f"[avvp train] AVVPConfig() bf16 batch {BATCH}, default path, DropPath + SpecAugment + "
        f"dropout + Gumbel + mixup: losses {[round(v, 5) for v in losses]}; {n_frozen} frozen "
        f"tensors bit-identical, {n_moved} trainable tensors moved, bn0 running stats moved; "
        f"launches per step {got} (plan {want}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _full_grad_gate("avvp train", lambda dtype, seed: MGNModel(cfg, dtype=dtype, device="cuda",
                                                               seed=seed),
                    loss_fn, dict(batch, mixup_lambda=torch.full_like(lam, 0.6)))
    step_ms, _, prof = _step_times("AVVP train step", step, state, batch, gen)
    return got, step_ms, prof


# ---------------------------------------------------------------------------
# AVQA: the question-answering fusion model (the frozen negative-frame Swin
# pass, an LSTM question encoder, grounding and question-as-query heads)
# ---------------------------------------------------------------------------

AVQA_OUT = ("qa_logits", "match_posi", "match_nega")


def _avqa_inputs(cfg, clips: int, seed: int, device):
    """Seeded waves, positive and negative frames, and question token ids."""
    wave, posi = _inputs(cfg, clips, seed, device)
    rng = np.random.RandomState(seed + 1)
    S = cfg.swin.img_size
    nega = rng.rand(clips, cfg.num_segments, S, S, 3).astype(np.float32)
    q = rng.randint(0, cfg.qst_vocab, (clips, cfg.max_qst_len))
    return wave, posi, torch.from_numpy(nega).to(device), torch.from_numpy(q).to(device)


def _avqa_batches(cfg, clips: int, steps: int, seed: int, device):
    """Seeded AVQA batches: inputs, answers, a per-frame mixup λ."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        wave, posi, nega, q = _avqa_inputs(cfg, clips, int(rng.randint(1 << 30)), device)
        answer = rng.randint(0, cfg.answer_vocab, clips)
        lam = rng.uniform(0.3, 0.7, clips * cfg.num_segments).astype(np.float32)
        out.append(dict(wave=wave, visual_posi=posi, visual_nega=nega, question=q,
                        answer=torch.from_numpy(answer).to(device),
                        mixup_lambda=torch.from_numpy(lam).to(device)))
    return out


def avqa_k3_shapes():
    """(geom, calls per forward) of the AVQA chain path's K3 geometries that
    the AVE chain path does not run: the positive pass's (adapters in every
    stage) and the frozen negative pass's (each stage's blocks)."""
    from avmoe_tpu_torch.config import AVQAConfig
    from avmoe_tpu_torch.moe.injection import chain_calls, swin_chain_calls

    cfg = AVQAConfig()
    ave = {g for g, _ in k3_shapes()}
    rows = {}
    for c in chain_calls(cfg.swin, cfg.htsat, cfg.injection) + swin_chain_calls(cfg.swin):
        if c.geom not in ave:
            rows[c.geom] = rows.get(c.geom, 0) + 1
    return list(rows.items())


def avs_k3_shapes():
    """(geom, calls per forward) of every K3 geometry of the AVS chain path
    (AVQA's positive-pass plan: adapters in every stage)."""
    from avmoe_tpu_torch.config import AVSConfig
    from avmoe_tpu_torch.moe.injection import chain_calls

    cfg = AVSConfig()
    rows = {}
    for c in chain_calls(cfg.swin, cfg.htsat, cfg.injection):
        rows[c.geom] = rows.get(c.geom, 0) + 1
    return list(rows.items())


def _at_shapes(err: float, tot) -> dict:
    return {"max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "library_ms": tot.get("library_ms")}


def phase_avs_kernels(gen):
    """Every kernel of the AVS path against its plain version at AVS's own
    shapes, 5 frames a clip where AVE, AVVP and AVQA run 10: K1, K2 and K3
    at a batch-BATCH and a batch-1 forward's grids, rows and windows (other
    tail tiles of K2's persistent schedule), K1b and K2b at the batch-BATCH
    MS3 step's. The calls per shape sum to the AVS plans. Returns
    {kernel: {"batch_N": max |d|, times}}."""
    from avmoe_tpu_torch.config import AVSConfig
    from avmoe_tpu_torch.models.avs import avs_kernel_launches
    from avmoe_tpu_torch.moe.injection import backward_launches

    cfg = AVSConfig()
    T = cfg.num_segments
    fwd, chain = avs_kernel_launches(cfg, False), avs_kernel_launches(cfg, True)
    bwd = backward_launches(cfg.swin, cfg.htsat, cfg.injection)
    k3 = avs_k3_shapes()
    planned = {"K1": sum(s[-1] for s in k1_shapes(T)), "K2": sum(s[-1] for s in k2_shapes(T)),
               "K3": sum(c for _, c in k3), "K1b": sum(s[-1] for s in k1b_shapes(T)),
               "K2b": sum(s[-1] for s in k2b_shapes(T))}
    want = {"K1": fwd["K1"], "K2": fwd["K2"], "K3": chain["K3"], "K1b": bwd["K1b"],
            "K2b": bwd["K2b"]}
    check(planned == want, f"AVS kernel shapes' calls {planned}, the AVS plans {want}")
    out = {k: {} for k in want}
    rel_by_K = {}
    for clips in (BATCH, 1):
        frames, key = clips * T, f"batch_{clips}"
        out["K1"][key] = _at_shapes(*phase_k1(gen, frames, f"AVS K1 b{clips}"))
        out["K2"][key] = _at_shapes(*phase_k2(gen, frames, f"AVS K2 b{clips}"))
        err, tot = phase_k3(gen, k3, f"AVS K3 b{clips}", frames)
        out["K3"][key] = _at_shapes(err, tot)
        for K, rel in tot["rel_by_K"].items():
            rel_by_K[K] = max(rel_by_K.get(K, 0.0), rel)
    frames = BATCH * T
    out["K1b"][f"batch_{BATCH}"] = _at_shapes(*phase_k1b(gen, frames, f"AVS K1b b{BATCH}"))
    out["K2b"][f"batch_{BATCH}"] = _at_shapes(*phase_k2b(gen, frames, f"AVS K2b b{BATCH}"))
    log(f"[avs] every kernel held against its plain version at AVS's shapes ({BATCH * T} and "
        f"{T} frames a forward, {BATCH * T} a step; {len(k3)} K3 geometries): max |d| "
        + ", ".join(f"{k} {max(v['max_abs_err'] for v in d.values()):.3e}"
                    for k, d in out.items()))
    return out, rel_by_K


def phase_avqa_tiny():
    """Tiny AVQAFusionModel in float32: the eval forward on both paths (the
    negative pass through K1 + K2, or K3 chains) and on the default path
    with the fused combine, one step's trainable gradients per leaf on both
    combines and a 2-step train curve on the default path, card (kernels)
    vs CPU (plain versions)."""
    from avmoe_tpu_torch.config import tiny_avqa_config
    from avmoe_tpu_torch.models.avqa import (
        AVQAFusionModel, avqa_kernel_launches, make_avqa_loss_fn)

    cfg = tiny_avqa_config()
    tag = "avqa tiny"
    cpu = AVQAFusionModel(cfg, device="cpu", seed=0)
    _nonzero_gates_(cpu, 1)
    ins = _avqa_inputs(cfg, 2, 2, "cpu")
    counters = _counters()
    for chains, fused in TINY_ROUTES:
        label = _route_label(chains, fused)
        cpu.encoder.block_chains = chains
        _set_fused_(cpu, fused, False)
        ref = cpu(*ins)
        gpu = AVQAFusionModel(cfg, device="cuda", seed=None, block_chains=chains)
        gpu.load_state_dict(cpu.state_dict())
        _set_fused_(gpu, fused, False)
        for c in counters.values():
            c.launches = 0
        out = gpu(*(t.cuda() for t in ins))
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        want = avqa_kernel_launches(cfg, chains)
        check(got == want, f"tiny AVQA {label}: launches {got}, want {want}")
        worst = _close_to_cpu(out, ref, AVQA_OUT, f"{tag} {label}")
        log(f"[{tag}] fp32 {label}, card (kernels) vs CPU (plain): every output, gating "
            f"probs and lb_loss within rtol 1e-3, atol 1e-4; outputs max |d| {worst:.3e}; "
            f"launches {got}")
    cpu.encoder.block_chains = False
    _set_fused_(cpu, False, False)

    gpu = AVQAFusionModel(cfg, device="cuda", seed=None)
    gpu.load_state_dict(cpu.state_dict())
    _tiny_train_vs_cpu(tag, cpu, gpu, make_avqa_loss_fn,
                       lambda n, dev: _avqa_batches(cfg, 2, n, 7, dev), steps=2, fused=True)


def _avqa_pooled(model, ins):
    """The positive pass's pooled features (f_v, f_a) of the encoder."""
    wave, posi = ins[0], ins[1]
    B, T = wave.shape[0], wave.shape[1]
    with torch.no_grad():
        f_v, f_a, _ = model.encoder(wave.reshape(B * T, -1),
                                    posi.reshape((B * T,) + tuple(posi.shape[2:])))
    return f_v.float(), f_a.float()


def phase_avqa_full():
    """AVQAConfig() in bfloat16 at batch 4 and 1 clips on both paths:
    launches, shapes, finiteness, gating sums; bf16 vs fp32 cosine of
    qa_logits and of the pooled encoder features, chain vs default, the
    match logits' differences (reported); accuracy through make_avqa_eval_fn;
    times, the negative pass alone, and a profile."""
    from avmoe_tpu_torch.config import AVQAConfig
    from avmoe_tpu_torch.metrics.avqa import AVQAAccuracy
    from avmoe_tpu_torch.models.avqa import (
        AVQAFusionModel, avqa_kernel_launches, make_avqa_eval_fn)

    cfg = AVQAConfig()
    T = cfg.num_segments
    t0 = time.perf_counter()
    model = AVQAFusionModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    _nonzero_gates_(model, 1)
    chain = AVQAFusionModel(cfg, dtype=torch.bfloat16, device="cuda", seed=None,
                            block_chains=True)
    chain.load_state_dict(model.state_dict())
    torch.cuda.synchronize()
    sites = len(model.encoder.sites)
    log(f"[avqa] AVQAConfig() bf16 built in {time.perf_counter() - t0:.1f} s (both paths), "
        f"{sum(p.numel() for p in model.parameters())} parameters, {sites} adapter sites, "
        f"{cfg.moe.num_experts} experts")
    ins = _avqa_inputs(cfg, BATCH, 3, "cuda")
    counters = _counters()
    paths = {"default path": model, "chain path": chain}
    outs, launches = {}, {}
    for label, m in paths.items():
        want = avqa_kernel_launches(cfg, m.encoder.block_chains)
        for clips in (BATCH, 1):
            for c in counters.values():
                c.launches = 0
            out = m(*(t[:clips] for t in ins))
            torch.cuda.synchronize()
            got = {k: c.launches for k, c in counters.items()}
            check(got == want, f"AVQA {label} batch {clips}: launches {got}, want {want}")
            shapes = {"qa_logits": (clips, cfg.fc_class), "match_posi": (clips * T, 2),
                      "match_nega": (clips * T, 2)}
            for key, shape in shapes.items():
                check(tuple(out[key].shape) == shape, f"AVQA {key} shape {tuple(out[key].shape)}")
                check(bool(torch.isfinite(out[key]).all()), f"AVQA {label} {key} not finite")
            for key in GATING:
                p = out["telemetry"][key]
                check(tuple(p.shape) == (sites, clips * T, cfg.moe.num_experts),
                      f"AVQA {key} shape {tuple(p.shape)}")
                check(bool(((p.sum(-1) - 1.0).abs() <= 1e-3).all()), f"AVQA {key} sums")
            if clips == BATCH:
                outs[label], launches[label] = out, got
            log(f"[avqa] {label} batch {clips}: shapes ok, finite, gating sums ok, launches "
                + " ".join(f"{k} {v}" for k, v in got.items()))

    f32 = AVQAFusionModel(cfg, dtype=torch.float32, device="cuda", seed=None)
    f32.load_state_dict(model.state_dict())
    nega = ins[2].reshape((BATCH * T,) + tuple(ins[2].shape[2:]))
    cos = {}
    for label, m in paths.items():
        f32.encoder.block_chains = m.encoder.block_chains
        ref = f32(*ins)
        fv16, fa16 = _avqa_pooled(m, ins)
        fv32, fa32 = _avqa_pooled(f32, ins)
        fn16 = m.negative_features(nega).float().mean(dim=1)
        fn32 = f32.negative_features(nega).mean(dim=1)
        cos[label] = {name: F.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()
                      for name, a, b in (("qa_logits", outs[label]["qa_logits"].float(),
                                          ref["qa_logits"]), ("f_v", fv16, fv32),
                                         ("f_a", fa16, fa32), ("f_v_nega", fn16, fn32))}
        match_d = {k: (outs[label][k].float() - ref[k]).abs().max().item()
                   for k in ("match_posi", "match_nega")}
        check(all(c >= 0.99 for c in cos[label].values()),
              f"AVQA {label}: bf16 vs fp32 cosines {cos[label]} (want >= 0.99)")
        log(f"[avqa] {label}: bf16 vs fp32 cosine " + ", ".join(
            f"{k} {v:.6f}" for k, v in cos[label].items()) + " (>= 0.99); reported, not gated: "
            "match logits' max |d| " + ", ".join(f"{k} {v:.3e}" for k, v in match_d.items()))
        del ref, fv16, fa16, fv32, fa32, fn16, fn32
    del f32
    torch.cuda.empty_cache()
    c = F.cosine_similarity(outs["chain path"]["qa_logits"].float().flatten(),
                            outs["default path"]["qa_logits"].float().flatten(), dim=0).item()
    check(c >= 0.99, f"AVQA bf16 chain vs default qa_logits cosine {c:.5f} < 0.99")
    log(f"[avqa] bf16 chain path vs default path qa_logits cosine {c:.6f} (>= 0.99)")

    acc = AVQAAccuracy()
    answer = torch.from_numpy(np.random.RandomState(5).randint(0, cfg.answer_vocab, BATCH))
    make_avqa_eval_fn(model)(dict(wave=ins[0], visual_posi=ins[1], visual_nega=ins[2],
                                  question=ins[3], answer=answer,
                                  qtype_str=["Audio_Counting", "Visual_Location",
                                             "Audio-Visual_Existential", ""][:BATCH]), acc)
    summary = acc.summary()
    check(all(math.isfinite(v) and 0 <= v <= 100 for v in summary.values()),
          f"AVQA accuracy {summary}")
    log(f"[avqa] accuracy of the batch-{BATCH} eval against seeded answers: {summary}")

    neg_ms = {}
    for label, m in paths.items():
        neg_ms[label] = time_ms(lambda m=m: m.negative_features(nega), iters=10, warmup=2)
    log(f"[time] AVQA negative pass alone (frozen Swin-V2-L over {BATCH * T} frames, bf16, CUDA "
        f"events): default path {neg_ms['default path']:.3f} ms, chain path "
        f"{neg_ms['chain path']:.3f} ms")
    fwd_ms, prof = {}, {}
    for label, m in paths.items():
        fwd_ms[label] = _times(m, f"AVQA {label}", *ins)
        prof[label] = phase_profile(f"AVQA {label}", lambda m=m: m(*ins), fwd_ms[label])
    neg_prof = phase_profile("AVQA negative pass (default path)",
                             lambda: model.negative_features(nega), neg_ms["default path"])
    del chain
    torch.cuda.empty_cache()
    return launches, fwd_ms, prof, neg_ms, neg_prof, cos, model


def phase_avqa_train(model):
    """The full AVQAConfig() train step in bf16 on the default path at batch
    BATCH, DropPath, SpecAugment, dropout and mixup on; the fp32 gradient
    gate; times, peak memory and a profile."""
    from avmoe_tpu_torch.config import AVQAConfig, TrainConfig
    from avmoe_tpu_torch.models.avqa import (
        AVQAFusionModel, avqa_kernel_launches, make_avqa_loss_fn)
    from avmoe_tpu_torch.moe.injection import backward_launches
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    cfg = AVQAConfig()
    lr = TrainConfig().lr
    state = create_train_state(model, TrainConfig(accum_steps=1, lr=lr, lr_mlp=lr),
                               steps_per_epoch=100)
    loss_fn = make_avqa_loss_fn(model)
    step = make_train_step(loss_fn)
    batch = _avqa_batches(cfg, BATCH, 1, 11, "cuda")[0]
    lam = batch.pop("mixup_lambda")             # λ drawn per frame from Beta(0.5, 0.5)
    # the negative pass runs K1 and K2 in the forward and no backward kernel
    fwd = avqa_kernel_launches(cfg, block_chains=False)
    want = {"K1": fwd["K1"], "K2": fwd["K2"], **backward_launches(cfg.swin, cfg.htsat,
                                                                   cfg.injection)}
    gen = torch.Generator(device="cuda").manual_seed(12)
    torch.cuda.reset_peak_memory_stats()
    got, losses, n_frozen, n_moved = _checked_steps("AVQA train", model, state, step, batch,
                                                    gen, want, ("bn0",))
    log(f"[avqa train] AVQAConfig() bf16 batch {BATCH}, default path, DropPath + SpecAugment + "
        f"dropout + mixup: losses {[round(v, 5) for v in losses]}; {n_frozen} frozen tensors "
        f"bit-identical, {n_moved} trainable tensors moved, bn0 running stats moved; launches "
        f"per step {got} (plan {want}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _full_grad_gate("avqa train", lambda dtype, seed: AVQAFusionModel(
        cfg, dtype=dtype, device="cuda", seed=seed), loss_fn,
        dict(batch, mixup_lambda=torch.full_like(lam, 0.6)))
    step_ms, peak, prof = _step_times("AVQA train step", step, state, batch, gen)
    return got, step_ms, peak, prof


# ---------------------------------------------------------------------------
# AVS: sound-source segmentation (the 'mha' / 'token' experts, the stage
# tokens, TPAVI, the FPN decoder)
# ---------------------------------------------------------------------------

AVS_FRAME = 224                  # the frames' size; the model resizes to Swin's 192


def _avs_tiny_cfg(setting: str):
    """The tiny AVS config with both resizes running (80-px frames to Swin's
    64, the stage grids to the (24, 12, 6, 3) pyramid), S4 or MS3."""
    import dataclasses

    from avmoe_tpu_torch.config import ms3_config, tiny_avs_config

    cfg = dataclasses.replace(tiny_avs_config(), pyramid_sizes=(24, 12, 6, 3), mask_size=96)
    return ms3_config(cfg) if setting == "ms3" else cfg


def _avs_noised_(model, seed: int) -> None:
    """_nonzero_gates_, and the 'token' experts' gate_self and TPAVI's W_z_bn
    scale (zero at init, which makes TPAVI the identity plus LayerNorm)."""
    _nonzero_gates_(model, seed)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in model.named_parameters():
            if name.endswith("gate_self") or name.endswith("W_z_bn.weight"):
                t.copy_((0.5 + 0.2 * torch.randn(t.shape, generator=g)).to(t.device))


def _avs_inputs(cfg, clips: int, seed: int, device, frame: int = AVS_FRAME):
    rng = np.random.RandomState(seed)
    T = cfg.num_segments
    imgs = rng.rand(clips, T, frame, frame, 3).astype(np.float32)
    wave = rng.randn(clips, T, cfg.audio_len).astype(np.float32) * 0.1
    return torch.from_numpy(imgs).to(device), torch.from_numpy(wave).to(device)


def _avs_masks(cfg, clips: int, seed: int, device):
    """Seeded synthetic masks (clips, T, mask, mask): one random rectangle a
    frame, the first frame of the first clip empty."""
    rng = np.random.RandomState(seed)
    M, T = cfg.mask_size, cfg.num_segments
    mask = np.zeros((clips, T, M, M), np.float32)
    for b in range(clips):
        for t in range(T):
            if b == 0 and t == 0:
                continue
            h0, w0 = rng.randint(0, M // 2, 2)
            h1, w1 = h0 + rng.randint(M // 8, M // 2), w0 + rng.randint(M // 8, M // 2)
            mask[b, t, h0:h1, w0:w1] = 1.0
    return torch.from_numpy(mask).to(device)


def _avs_batches(cfg, clips: int, steps: int, seed: int, device, frame: int = AVS_FRAME):
    """Seeded AVS batches: frames, waves, masks ((B, H, W) first frames for
    S4, (B, T, H, W) for MS3) and a per-frame mixup λ."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        s = int(rng.randint(1 << 30))
        imgs, wave = _avs_inputs(cfg, clips, s, device, frame)
        mask = _avs_masks(cfg, clips, s + 1, device)
        lam = rng.uniform(0.3, 0.7, clips * cfg.num_segments).astype(np.float32)
        out.append(dict(images=imgs, wave=wave,
                        mask=mask[:, 0] if cfg.setting == "s4" else mask,
                        mixup_lambda=torch.from_numpy(lam).to(device)))
    return out


def _avs_outputs(out):
    """An AVS output dict with its lists spread into keys: mask_logits,
    fmap_i, afea_i, telemetry."""
    flat = {"mask_logits": out["mask_logits"], "telemetry": out["telemetry"]}
    for i, (f, a) in enumerate(zip(out["feature_map_list"], out["a_fea_list"])):
        flat[f"fmap_{i}"] = f
        if a is not None:
            flat[f"afea_{i}"] = a
    return flat


@contextlib.contextmanager
def _given_router_noise(noise: torch.Tensor):
    """The routers' train noise made the same on the CPU and the card: every
    adapter call takes `noise` (B', E)."""
    import avmoe_tpu_torch.moe.adapter as adapter

    kept = adapter.router_noise
    adapter.router_noise = lambda shape, generator, device: noise.to(device)
    try:
        yield
    finally:
        adapter.router_noise = kept


def phase_avs_tiny():
    """Tiny AVSModel in float32, S4 and MS3: the eval forward on both paths
    and on the default path with the fused combine, card (kernels) vs CPU
    (plain versions), every output, the gating probs and lb_loss, and the
    launches; then the train semantics of MS3 and of S4 (HTS-AT trainable),
    one step's gradients per leaf on both combines and a 2-step curve, with
    the router noise given."""
    from avmoe_tpu_torch.models.avs import (
        AVSModel, avs_frozen_scopes, avs_kernel_launches, make_avs_loss_fn)

    counters = _counters()
    tag = "avs tiny"
    for setting in ("s4", "ms3"):
        cfg = _avs_tiny_cfg(setting)
        cpu = AVSModel(cfg, device="cpu", seed=0)
        _avs_noised_(cpu, 1)
        ins = _avs_inputs(cfg, 2, 2, "cpu", frame=80)
        r = np.random.RandomState(1)
        nudged = tuple(t * (1 + 1e-6 * torch.from_numpy(r.randn(*t.shape).astype(np.float32)))
                       for t in ins)
        for chains, fused in TINY_ROUTES:
            label = f"{tag} {setting} {_route_label(chains, fused)}"
            cpu.encoder.block_chains = chains
            _set_fused_(cpu, fused, False)
            ref = _avs_outputs(cpu(*ins))
            # S4's 'mha' expert attends across the 4 frames with sharp
            # softmaxes: a 1e-6 relative change of the inputs moves the CPU's
            # own mask logits by ~2e-4, 15x MS3's 'token' model
            moved = _avs_outputs(cpu(*nudged)) if setting == "s4" else None
            gpu = AVSModel(cfg, device="cuda", seed=None, block_chains=chains)
            gpu.load_state_dict(cpu.state_dict())
            _set_fused_(gpu, fused, False)
            for c in counters.values():
                c.launches = 0
            out = _avs_outputs(gpu(*(t.cuda() for t in ins)))
            torch.cuda.synchronize()
            got = {k: c.launches for k, c in counters.items()}
            want = avs_kernel_launches(cfg, chains)
            check(got == want, f"{label}: launches {got}, want {want}")
            keys = tuple(k for k in ref if k != "telemetry")
            worst = _close_to_cpu(out, ref, keys, label, moved)
            own = "" if moved is None else (
                "or 4x the CPU's own move under a 1e-6 input change (mask logits "
                f"{(moved['mask_logits'] - ref['mask_logits']).abs().max().item():.3e})")
            log(f"[{tag}] fp32 {label}, card (kernels) vs CPU (plain): mask logits, the "
                f"4 feature maps, the aligned audio, gating probs and lb_loss within rtol "
                f"1e-3, atol 1e-4 {own}; outputs max |d| {worst:.3e}; launches {got}")
        cpu.encoder.block_chains = False
        _set_fused_(cpu, False, False)
    gpu = AVSModel(cfg, device="cuda", seed=None)
    gpu.load_state_dict(cpu.state_dict())
    noise = torch.from_numpy(np.random.RandomState(4).randn(2 * cfg.num_segments, 2)
                             .astype(np.float32))
    with _given_router_noise(noise):
        _tiny_train_vs_cpu(f"{tag} ms3", cpu, gpu, make_avs_loss_fn,
                           lambda n, dev: _avs_batches(cfg, 2, n, 7, dev, frame=80),
                           steps=2, fused=True)
    # S4 with HTS-AT trainable: its backward through K1b's dbias and K2b's
    # weight gradients on the card, the plain versions' on the CPU
    cfg = _avs_tiny_cfg("s4")
    cpu = AVSModel(cfg, device="cpu", seed=0)
    _avs_noised_(cpu, 1)
    gpu = AVSModel(cfg, device="cuda", seed=None)
    gpu.load_state_dict(cpu.state_dict())
    with _given_router_noise(noise):
        _tiny_train_vs_cpu(f"{tag} s4", cpu, gpu, make_avs_loss_fn,
                           lambda n, dev: _avs_batches(cfg, 2, n, 7, dev, frame=80),
                           steps=2, fused=True,
                           frozen_scopes=avs_frozen_scopes(cfg), nudge=True)


def _avs_stage_pooled(model, images, wave):
    """Each stage's visual tokens of the encoder (the decoder's inputs),
    pooled over the tokens, float32."""
    from avmoe_tpu_torch.heads.avs import resize_bicubic

    B, T = images.shape[0], images.shape[1]
    S = model.cfg.swin.img_size
    with torch.no_grad():
        imgs = resize_bicubic(images.reshape((B * T,) + tuple(images.shape[2:])), S, S)
        _, _, tele = model.encoder.forward_tokens(wave.reshape(B * T, -1), imgs,
                                                  collect_stages=True)
    return [t.float().mean(dim=1) for t in tele["stage_tokens"]]


def _avs_check_outputs(cfg, out, clips: int, label: str) -> None:
    T, M = cfg.num_segments, cfg.mask_size
    check(tuple(out["mask_logits"].shape) == (clips * T, M, M),
          f"{label}: mask_logits shape {tuple(out['mask_logits'].shape)}")
    for i, (f, a) in enumerate(zip(out["feature_map_list"], out["a_fea_list"])):
        p = cfg.pyramid_sizes[i]
        check(tuple(f.shape) == (clips * T, p, p, cfg.channel), f"{label}: fmap {i} shape")
        check(a is not None and tuple(a.shape) == (clips, T, cfg.channel),
              f"{label}: a_fea {i} shape")
        check(bool(torch.isfinite(f).all() and torch.isfinite(a).all()),
              f"{label}: stage {i} not finite")
    check(bool(torch.isfinite(out["mask_logits"]).all()), f"{label}: mask_logits not finite")
    for key in GATING:
        p = out["telemetry"][key]
        check(tuple(p.shape) == (12, clips * T, cfg.moe.num_experts),
              f"{label}: {key} shape {tuple(p.shape)}")
        check(bool(((p.sum(-1) - 1.0).abs() <= 1e-3).all()), f"{label}: {key} sums")
    lb = float(out["telemetry"]["lb_loss"])
    check(math.isfinite(lb) and lb >= 48 * 2 * math.log(2) - 1e-2, f"{label}: lb_loss {lb}")


def _avs_tpavi_time(model, images, wave):
    """TPAVI alone on the inputs a forward gives it (forward hooks): its
    four calls' time by CUDA events and their device time by the profiler."""
    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.append((mod, args)))
             for m in model.tpavi.values()]
    model(images, wave)
    for h in hooks:
        h.remove()

    def run():
        with torch.no_grad():
            for mod, args in seen:
                mod(*args)

    ms = time_ms(run, iters=10, warmup=2)
    # the device does not idle here: the events' ms is device time, not a
    # wall that bounds the profiler's kernel timings
    busy, _, _ = phase_profile("AVS TPAVI alone (4 stages)", run, None)
    N0 = int(np.prod(seen[0][1][0].shape[1:4]))
    log(f"[avs] TPAVI alone, its 4 calls of one batch-{images.shape[0]} forward: {ms:.3f} ms "
        f"(CUDA events), device busy {busy} ms; stage 0's float32 logits (B, N, N), N = "
        f"{N0}: {images.shape[0] * N0 * N0 * 4 / 2**30:.2f} GiB")
    return ms, busy


def phase_avs_full():
    """AVSConfig() (S4) in bfloat16 at batch 4 and 1 clips on both paths, and
    the MS3 config at batch 4 on the default path: launches, shapes,
    finiteness, gating sums; bf16 vs fp32 at the same batch (mask logits and
    each stage's pooled tokens), chain vs default; mask IoU and F-measure on
    synthetic masks; times, TPAVI alone, and a profile."""
    from avmoe_tpu_torch.config import AVSConfig, ms3_config
    from avmoe_tpu_torch.metrics.avs import eval_fmeasure, mask_iou
    from avmoe_tpu_torch.models.avs import AVSModel, avs_kernel_launches, make_avs_eval_fn

    cfg = AVSConfig()
    T = cfg.num_segments
    t0 = time.perf_counter()
    model = AVSModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    _avs_noised_(model, 1)
    chain = AVSModel(cfg, dtype=torch.bfloat16, device="cuda", seed=None, block_chains=True)
    chain.load_state_dict(model.state_dict())
    torch.cuda.synchronize()
    log(f"[avs] AVSConfig() bf16 built in {time.perf_counter() - t0:.1f} s (both paths), "
        f"{sum(p.numel() for p in model.parameters())} parameters, "
        f"{len(model.encoder.sites)} adapter sites, {cfg.moe.num_experts} experts")
    ins = _avs_inputs(cfg, BATCH, 3, "cuda")
    counters = _counters()
    paths = {"default path": model, "chain path": chain}
    outs, launches = {}, {}
    for label, m in paths.items():
        want = avs_kernel_launches(cfg, m.encoder.block_chains)
        for clips in (BATCH, 1):
            for c in counters.values():
                c.launches = 0
            out = m(*(t[:clips] for t in ins))
            torch.cuda.synchronize()
            got = {k: c.launches for k, c in counters.items()}
            check(got == want, f"AVS {label} batch {clips}: launches {got}, want {want}")
            _avs_check_outputs(cfg, out, clips, f"AVS {label} batch {clips}")
            if clips == BATCH:
                outs[label], launches[label] = out, got
            log(f"[avs] S4 {label} batch {clips}: shapes ok, finite, gating sums ok, lb_loss "
                f"{float(out['telemetry']['lb_loss']):.4f}, launches "
                + " ".join(f"{k} {v}" for k, v in got.items()))

    f32 = AVSModel(cfg, dtype=torch.float32, device="cuda", seed=None)
    f32.load_state_dict(model.state_dict())
    cos, f32_logits = {}, {}
    for label, m in paths.items():
        f32.encoder.block_chains = m.encoder.block_chains
        f32_logits[label] = f32(*ins)["mask_logits"]
        pooled16, pooled32 = _avs_stage_pooled(m, *ins), _avs_stage_pooled(f32, *ins)
        cos[label] = {"mask_logits": F.cosine_similarity(
            outs[label]["mask_logits"].float().flatten(), f32_logits[label].flatten(),
            dim=0).item()}
        for i, (a, b) in enumerate(zip(pooled16, pooled32)):
            cos[label][f"stage_{i}"] = F.cosine_similarity(a.flatten(), b.flatten(),
                                                           dim=0).item()
        check(all(c >= 0.99 for c in cos[label].values()),
              f"AVS {label}: bf16 vs fp32 cosines {cos[label]} (want >= 0.99)")
        log(f"[avs] S4 {label}, batch {BATCH}: bf16 vs fp32 cosine "
            + ", ".join(f"{k} {v:.6f}" for k, v in cos[label].items()) + " (>= 0.99)")
    c = F.cosine_similarity(outs["chain path"]["mask_logits"].float().flatten(),
                            outs["default path"]["mask_logits"].float().flatten(), dim=0).item()
    check(c >= 0.99, f"AVS bf16 chain vs default mask logits cosine {c:.5f} < 0.99")
    cos["chain vs default"] = c
    log(f"[avs] S4 bf16 chain path vs default path mask logits cosine {c:.6f} (>= 0.99)")

    masks = _avs_masks(cfg, BATCH, 5, "cuda")
    res = make_avs_eval_fn(model)(dict(images=ins[0], wave=ins[1], mask=masks))
    logits16 = outs["default path"]["mask_logits"].float()
    agree = (f32_logits["default path"] > 0).float()
    metrics = {"miou": float(res["miou"]), "fmeasure": float(res["fmeasure"]),
               "miou_vs_fp32_masks": float(mask_iou(logits16, agree)),
               "fmeasure_vs_fp32_masks": float(eval_fmeasure(logits16, agree))}
    check(all(math.isfinite(v) and 0 <= v <= 1 for v in metrics.values()),
          f"AVS metrics {metrics}")
    log("[avs] S4 batch-4 eval metrics (reported): against seeded synthetic rectangles "
        f"(one frame empty) mIoU {metrics['miou']:.4f}, F-measure {metrics['fmeasure']:.4f}; "
        "against the fp32 forward's own masks (logit > 0) mIoU "
        f"{metrics['miou_vs_fp32_masks']:.4f}, F-measure {metrics['fmeasure_vs_fp32_masks']:.4f}")
    del f32, f32_logits
    torch.cuda.empty_cache()

    ms3 = ms3_config(cfg)
    m3 = AVSModel(ms3, dtype=torch.bfloat16, device="cuda", seed=0)
    _avs_noised_(m3, 2)
    for c in counters.values():
        c.launches = 0
    out3 = m3(*ins)
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    want = avs_kernel_launches(ms3, False)
    check(got == want, f"AVS MS3 batch {BATCH}: launches {got}, want {want}")
    _avs_check_outputs(ms3, out3, BATCH, f"AVS MS3 batch {BATCH}")
    f32 = AVSModel(ms3, dtype=torch.float32, device="cuda", seed=None)
    f32.load_state_dict(m3.state_dict())
    cos["ms3"] = {"mask_logits": F.cosine_similarity(
        out3["mask_logits"].float().flatten(), f32(*ins)["mask_logits"].flatten(), dim=0).item()}
    for i, (a, b) in enumerate(zip(_avs_stage_pooled(m3, *ins), _avs_stage_pooled(f32, *ins))):
        cos["ms3"][f"stage_{i}"] = F.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()
    check(all(v >= 0.99 for v in cos["ms3"].values()),
          f"AVS MS3: bf16 vs fp32 cosines {cos['ms3']} (want >= 0.99)")
    log(f"[avs] MS3 default path batch {BATCH}: launches {got}, shapes ok, finite; bf16 vs fp32 "
        "cosine " + ", ".join(f"{k} {v:.6f}" for k, v in cos["ms3"].items()) + " (>= 0.99)")
    del f32, out3
    torch.cuda.empty_cache()

    fwd_ms, prof = {}, {}
    for label, m in paths.items():
        fwd_ms[label] = _times(m, f"AVS {label}", *ins)
        prof[label] = phase_profile(f"AVS {label}", lambda m=m: m(*ins), fwd_ms[label])
    tpavi = _avs_tpavi_time(model, *ins)
    del chain
    torch.cuda.empty_cache()
    return launches, fwd_ms, prof, tpavi, cos, metrics, model, m3


def phase_avs_train(s4_model, model):
    """The full MS3 train step in bf16 on the default path at batch BATCH
    (DropPath, SpecAugment, dropout, router noise and mixup on): launches,
    frozen bit-identical, every trainable moved, running stats moved; the
    fp32 gradient gate; times, peak memory and a profile. Then the same for
    the S4 step, HTS-AT trainable (every HTS-AT sub-block launches K1b and
    K2b, which give its weights' gradients), Swin frozen."""
    from avmoe_tpu_torch.config import AVSConfig, TrainConfig, ms3_config
    from avmoe_tpu_torch.models.avs import (
        AVSModel, avs_backward_launches, avs_frozen_scopes, avs_kernel_launches,
        make_avs_loss_fn)
    from avmoe_tpu_torch.moe.injection import backward_launches
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    cfg = ms3_config(AVSConfig())
    lr = TrainConfig().lr
    tcfg = TrainConfig(accum_steps=1, lr=lr, lr_mlp=lr)
    state = create_train_state(model, tcfg, steps_per_epoch=100,
                               frozen_scopes=avs_frozen_scopes(cfg))
    loss_fn = make_avs_loss_fn(model)
    step = make_train_step(loss_fn)
    batch = _avs_batches(cfg, BATCH, 1, 11, "cuda")[0]
    lam = batch.pop("mixup_lambda")             # λ drawn per frame from Beta(0.5, 0.5)
    fwd = avs_kernel_launches(cfg, block_chains=False)
    want = {"K1": fwd["K1"], "K2": fwd["K2"], **backward_launches(cfg.swin, cfg.htsat,
                                                                   cfg.injection)}
    gen = torch.Generator(device="cuda").manual_seed(12)
    torch.cuda.reset_peak_memory_stats()
    got, losses, n_frozen, n_moved = _checked_steps("AVS MS3 train", model, state, step, batch,
                                                    gen, want, ("bn0", "W_z_bn"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[avs train] MS3 AVSConfig() bf16 batch {BATCH}, default path, DropPath + SpecAugment "
        f"+ dropout + router noise + mixup: losses {[round(v, 5) for v in losses]}; {n_frozen} "
        f"frozen tensors bit-identical, {n_moved} trainable tensors moved, bn0 and W_z_bn "
        f"running stats moved; launches per step {got} (plan {want}); peak memory {peak:.2f} "
        f"GiB")
    _full_grad_gate("avs train", lambda dtype, seed: AVSModel(
        cfg, dtype=dtype, device="cuda", seed=seed), loss_fn,
        dict(batch, mixup_lambda=torch.full_like(lam, 0.6)))
    step_ms, step_peak, prof = _step_times("AVS MS3 train step", step, state, batch, gen)

    # S4: HTS-AT trains, its gradients from K1b's dbias and K2b's weight
    # gradients; Swin stays frozen
    s4 = AVSConfig()
    scopes = avs_frozen_scopes(s4)
    s4_state = create_train_state(s4_model, tcfg, steps_per_epoch=100, frozen_scopes=scopes)
    s4_loss = make_avs_loss_fn(s4_model)
    s4_step = make_train_step(s4_loss)
    s4_batch = _avs_batches(s4, BATCH, 1, 13, "cuda")[0]
    s4_lam = s4_batch.pop("mixup_lambda")       # λ drawn per frame from Beta(0.5, 0.5)
    fwd = avs_kernel_launches(s4, block_chains=False)
    s4_want = {"K1": fwd["K1"], "K2": fwd["K2"], **avs_backward_launches(s4)}
    htsat = [n for n in s4_state.trainable if n.startswith("encoder.htsat.")]
    for part in ("relative_position_bias_table", "mlp.fc1.weight", "mlp.fc2.weight",
                 "norm2.weight"):
        have = [n for n in htsat if n.endswith(part)]
        check(len(have) == sum(s4.htsat.depths), f"AVS S4: {len(have)} trainable HTS-AT "
              f"{part}, want one a block ({sum(s4.htsat.depths)})")
    check(not any(n.startswith("encoder.swin.") and "moe" not in n for n in s4_state.trainable),
          "AVS S4: a Swin parameter is trainable")
    torch.cuda.reset_peak_memory_stats()
    s4_got, s4_losses, s4_frozen, s4_moved = _checked_steps(
        "AVS S4 train", s4_model, s4_state, s4_step, s4_batch, gen, s4_want, ("bn0", "W_z_bn"))
    s4_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[avs train] S4 AVSConfig() bf16 batch {BATCH}, default path, HTS-AT trainable, "
        f"DropPath + SpecAugment + dropout + router noise + mixup: losses "
        f"{[round(v, 5) for v in s4_losses]}; {s4_frozen} frozen tensors (Swin) bit-identical, "
        f"{s4_moved} trainable tensors moved ({len(htsat)} of HTS-AT: every block's "
        f"relative-position table, fc1, fc2, norm2 among them), bn0 and W_z_bn running stats "
        f"moved; launches per step {s4_got} (plan {s4_want}); peak memory {s4_peak:.2f} GiB")
    _full_grad_gate("avs s4 train", lambda dtype, seed: AVSModel(
        s4, dtype=dtype, device="cuda", seed=seed), s4_loss,
        dict(s4_batch, mixup_lambda=torch.full_like(s4_lam, 0.6)), frozen_scopes=scopes)
    s4_ms, s4_step_peak, s4_prof = _step_times("AVS S4 train step", s4_step, s4_state,
                                               s4_batch, gen)
    s4_out = dict(launches=s4_got, step_ms=s4_ms, peak=max(s4_peak, s4_step_peak), prof=s4_prof)
    return got, step_ms, max(peak, step_peak), prof, s4_out


# ---------------------------------------------------------------------------
# The AVSBench baseline (models/avs_baseline.py) in float32: VGGish embeddings
# from the wave, a PVT-v2-b5 or ResNet-50 encoder, ASPP, TPAVI and the FPN
# decoder; and every other module of its slice (the legacy backbones, the
# attention zoo, the audio-guided attention, the loss library) card vs CPU
# ---------------------------------------------------------------------------

BASELINE_T = 5                   # AVSBench S4: 5 frames a clip at 224 px, 5 s of 16 kHz
BASELINE_FRAME = 224
BASELINE_WAVE = 5 * 16_000


def baseline_seed_init_stalls(names) -> set:
    """The parameters of an AVSBaselineModel that an S4 step cannot move
    from the seeded init: TPAVI's W_z set (`TPAVI_W_Z_STALLS`) and, since
    the S4 loss has no masked audio-visual term, the aligned audio's
    projection, which only feeds phi."""
    dead = TPAVI_W_Z_STALLS + r"|^tpavi_b\d+\.align_channel\."
    return {n for n in names if re.search(dead, n)}


@torch.no_grad()
def _noised_(module, seed: int):
    """Seeded noise in every parameter and running statistic of `module`
    (kernels at 1 / sqrt(fan-in), norm scales near 1, biases at 0.1,
    running variances positive), so that no branch of a card-vs-CPU check
    is zero. Returns the module."""
    from avmoe_tpu_torch.ops.norm import BatchNorm, LayerNorm

    g = torch.Generator(device="cpu").manual_seed(seed)
    for mod in module.modules():
        norm = isinstance(mod, (LayerNorm, BatchNorm))
        for name, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            n = torch.randn(t.shape, generator=g)
            if name == "running_var":
                v = 0.5 + 0.2 * n.abs()
            elif norm and name == "weight":
                v = 1.0 + 0.1 * n
            elif t.dim() >= 2:
                v = n / math.sqrt(t[0].numel())
            else:
                v = 0.1 * n
            t.copy_(v.to(t.device, t.dtype))
    return module


def _to_card(x):
    """x with its tensors (in tuples, lists and dicts) copied to the card."""
    if isinstance(x, torch.Tensor):
        return x.cuda()
    if isinstance(x, dict):
        return {k: _to_card(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to_card(v) for v in x)
    return x


def _outputs_close(label: str, got, ref) -> float:
    """Every tensor of `got` (card) against `ref` (CPU), in tuples, lists and
    dicts, rtol 1e-3, atol 1e-4; the largest |d|."""
    def flat(o):
        if isinstance(o, dict):
            o = [o[k] for k in sorted(o)]
        if isinstance(o, (tuple, list)):
            return [t for v in o for t in flat(v)]
        return [o] if isinstance(o, torch.Tensor) else []

    got, ref = flat(got), flat(ref)
    check(len(got) == len(ref) and got, f"{label}: {len(got)} outputs vs {len(ref)}")
    worst = 0.0
    for a, b in zip(got, ref):
        check(a.is_cuda and a.shape == b.shape, f"{label}: output on the card, shape")
        d = (a.cpu() - b).abs()
        worst = max(worst, d.max().item() if d.numel() else 0.0)
        check(bool((d <= 1e-4 + 1e-3 * b.abs()).all()), f"{label}: card vs CPU max |d| "
              f"{d.max().item():.3e}")
    return worst


def _module_vs_cpu(label: str, cpu_mod, *args, **kwargs) -> float:
    """cpu_mod on the CPU and a copy on the card, on the same inputs."""
    gpu_mod = copy.deepcopy(cpu_mod).cuda()
    with torch.no_grad():
        ref = cpu_mod(*args, **kwargs)
        got = gpu_mod(*_to_card(args), **{k: _to_card(v) for k, v in kwargs.items()})
    torch.cuda.synchronize()
    return _outputs_close(label, got, ref)


def _grads_vs_cpu(label: str, cpu, gpu, loss_fn, batch):
    """One train forward's loss (rtol 1e-4) and every parameter's gradient,
    card vs CPU, as the tiny train phases hold them (`_grad_cosines`: the
    whole gradient's cosine and every leaf's above 1e-5 of the largest rms
    >= 0.9999); then the running statistics the forward left, rtol 1e-3,
    atol 1e-4. Returns (the whole cosine, the lowest leaf's)."""
    out = {}
    for name, model, b in (("cpu", cpu, batch), ("gpu", gpu, _to_card(batch))):
        loss, _ = loss_fn(model, b, None)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
        out[name] = (loss.item(), {n: g.detach().flatten() for n, g in zip(names, grads)})
    (l_cpu, ref), (l_gpu, got) = out["cpu"], out["gpu"]
    check(abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu), f"{label}: loss {l_gpu} vs CPU {l_cpu}")
    whole, low, leaf = _grad_cosines(got, ref)
    check(whole >= 0.9999 and low >= 0.9999, f"{label}: gradients card vs CPU cosine "
          f"{whole:.7f}, lowest leaf {low:.7f} ({leaf})")
    stats_cpu = dict(cpu.named_buffers())
    for n, b in gpu.named_buffers():
        check(torch.allclose(b.cpu(), stats_cpu[n], rtol=1e-3, atol=1e-4),
              f"{label}: running statistic {n} card vs CPU")
    return whole, low


def phase_avs_baseline_tiny():
    """Every module of the baseline's slice in float32 at a tiny config, card
    vs CPU on the same weights and inputs (rtol 1e-3, atol 1e-4): VGGish on
    4 examples; PVT-v2-b0; ResNet at depths 1-1-1-1 (eval and train mode);
    the baseline with both encoders (64-px frames, T = 2, channel 32): the
    eval outputs, then one S4 train forward's loss, its gradients (cosines
    per leaf, as phase 12 holds them) and the running statistics; the legacy backbones, the attention zoo, the
    audio-guided attention and the loss library."""
    import avmoe_tpu_torch.losses.classification as cl
    import avmoe_tpu_torch.losses.contrastive as ct
    import avmoe_tpu_torch.losses.yb as yb
    from avmoe_tpu_torch.backbones import legacy
    from avmoe_tpu_torch.backbones.pvt import PVTv2, pvt_v2_b0
    from avmoe_tpu_torch.backbones.resnet import B2ResNet
    from avmoe_tpu_torch.backbones.vggish import VGGish, waveform_to_examples
    from avmoe_tpu_torch.heads.audio_guided import AudioGuidedAttention
    from avmoe_tpu_torch.models.avs_baseline import AVSBaselineModel, make_avs_baseline_loss_fn
    from avmoe_tpu_torch.ops import attention_zoo as zoo

    rng = np.random.RandomState(41)
    r = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    u = lambda *s: torch.from_numpy(rng.uniform(0.02, 0.98, s).astype(np.float32))
    hot = lambda *s: torch.from_numpy((rng.rand(*s) < 0.2).astype(np.float32))
    worst = {}
    ex = waveform_to_examples(0.1 * r(2, 32_000))[..., None].reshape(-1, 96, 64, 1)
    worst["vggish"] = _module_vs_cpu("tiny VGGish", _noised_(VGGish(), 1), ex)
    frames = torch.rand((4, 64, 64, 3), generator=torch.Generator().manual_seed(2))
    worst["pvt_v2_b0"] = _module_vs_cpu("tiny PVT-v2-b0", _noised_(pvt_v2_b0(), 2), frames)
    res = _noised_(B2ResNet(depths=(1, 1, 1, 1)), 3)
    worst["resnet_eval"] = _module_vs_cpu("tiny ResNet eval", res, frames)
    gpu_res = copy.deepcopy(res).cuda()
    with torch.no_grad():
        worst["resnet_train"] = _outputs_close("tiny ResNet train", gpu_res(frames.cuda(),
                                                                          train=True),
                                               res(frames, train=True))
    gbufs = dict(gpu_res.named_buffers())
    check(all(torch.allclose(gbufs[n].cpu(), b, rtol=1e-3, atol=1e-4)
              for n, b in res.named_buffers()), "tiny ResNet train: running stats")
    cosines = {}
    for backbone in ("pvt", "resnet"):
        enc = PVTv2(dims=(32, 64, 160, 256), depths=(1, 1, 1, 1), mlp_ratios=(8, 8, 4, 4),
                    drop_path_rate=0.0) if backbone == "pvt" else B2ResNet(depths=(1, 1, 1, 1))
        cpu = _noised_(AVSBaselineModel(backbone, channel=32, num_segments=2, device="cpu",
                                        seed=None, encoder=enc), 4)
        imgs, audio = torch.rand((2, 2, 64, 64, 3), generator=torch.Generator().manual_seed(5)), \
            r(2, 2, 128)
        label = f"tiny AVS baseline {backbone}"
        worst[f"baseline_{backbone}"] = _module_vs_cpu(label, cpu, imgs, audio)
        gpu = copy.deepcopy(cpu).cuda()
        batch = dict(images=imgs, audio_feature=audio,
                     mask=(torch.rand((2, 64, 64), generator=torch.Generator().manual_seed(6))
                           > 0.6).float())
        cosines[backbone] = _grads_vs_cpu(f"{label} S4 train", cpu, gpu,
                                          make_avs_baseline_loss_fn(cpu), batch)
    worst["resnet18"] = _module_vs_cpu("tiny ResNet-18", _noised_(legacy.ResNet18(5), 7),
                                       torch.rand((2, 64, 64, 3),
                                                  generator=torch.Generator().manual_seed(8)))
    worst["netvlad"] = _module_vs_cpu("tiny NetVLAD", _noised_(legacy.NetVLAD(4, 8), 9),
                                      r(2, 4, 4, 8))
    worst["avenet"] = _module_vs_cpu("tiny AVENet", _noised_(legacy.AVENet(24), 10),
                                     r(2, 32, 16, 1))
    worst["simple_vit"] = _module_vs_cpu(
        "tiny SimpleViT", _noised_(legacy.SimpleViT(16, 2, 2, 8, num_patches=16), 11),
        r(2, 32, 32, 3))
    worst["phm_linear"] = _module_vs_cpu("tiny PHMLinear", _noised_(legacy.PHMLinear(2, 8, 6),
                                                                    12), r(3, 8))
    mask = torch.from_numpy(rng.rand(2, 3, 5) > 0.3)
    worst["scaled_dot_product"] = _module_vs_cpu(
        "ScaledDotProductAttention", zoo.ScaledDotProductAttention(), r(2, 3, 8), r(2, 5, 8),
        r(2, 5, 4), mask)
    worst["additive"] = _module_vs_cpu("AdditiveAttention",
                                       _noised_(zoo.AdditiveAttention(8, 6, 4), 13),
                                       r(2, 3, 8), r(2, 5, 6), r(2, 5, 7))
    worst["location_aware"] = _module_vs_cpu(
        "LocationAwareAttention", _noised_(zoo.LocationAwareAttention(8, 6, 4, 3, True), 14),
        r(2, 8), r(2, 5, 6), torch.softmax(r(2, 5), -1))
    worst["multi_head"] = _module_vs_cpu("MultiHeadAttention",
                                         _noised_(zoo.MultiHeadAttention(10, 6, 7, 8, 2), 15),
                                         r(2, 3, 10), r(2, 5, 6), r(2, 5, 7))
    worst["audio_guided"] = _module_vs_cpu(
        "AudioGuidedAttention", _noised_(AudioGuidedAttention(16, 8, 12), 16),
        r(2, 2, 3, 3, 16), r(2, 2, 8))
    t28, p28 = hot(6, 28), u(6, 28)
    bags = u(10, 10, 2, 28)
    losses = {
        "label_smoothed_bce": (cl.label_smoothed_bce, (p28, t28, 0.1)),
        "asymmetric_loss": (cl.asymmetric_loss, (p28, t28)),
        "yb_loss": (yb.yb_loss, (bags, torch.tensor([2, 2, 0, 5]), torch.tensor([1, 3, 4, 5]),
                                 t28)),
        "yb_loss2_ada": (lambda *a: yb.yb_loss2("ada", x1=a[0], x2=a[1], target_pair=a[2:]),
                         (r(6, 16), r(6, 16), t28, hot(6, 28))),
        "yb_loss2_mimix": (lambda *a: yb.yb_loss2("mimix", x1=a[0], x2=a[1], target=a[2],
                                                  rand_idx=a[3], sample_idx=a[4]),
                           (r(6, 16), r(6, 16), t28, torch.tensor([5, 4, 2, 0, 1, 3]),
                            torch.tensor([0, 3, 3, 1, 1, 2]))),
        "contrastive_loss": (ct.contrastive_loss, (r(8, 5), r(8, 5), hot(8))),
        "info_nce_loss": (ct.info_nce_loss, (r(3, 10, 12), r(3, 10, 12))),
        "mask_info_nce_loss": (ct.mask_info_nce_loss, (r(8, 12), r(8, 12), torch.eye(8)[:6])),
        "contrastive_yb_loss": (ct.yb_loss, (bags, torch.tensor([2, 0, 1, 5]),
                                             torch.tensor([1, 3, 4, 5]), t28)),
        "contrastive_yb_loss2_mix": (lambda *a: ct.yb_loss2(*a, aug_type="mix"),
                                     (u(13, 28), u(13, 28), torch.tensor([4, 0, 2]),
                                      torch.tensor([1, 1, 5]), t28)),
    }
    for name, (fn, args) in losses.items():
        ref, got = fn(*args), fn(*_to_card(args))
        d = abs(float(got) - float(ref))
        check(got.is_cuda and d <= 1e-4 * abs(float(ref)) + 1e-6, f"{name}: card {float(got)} "
              f"vs CPU {float(ref)}")
        worst[name] = d
    log(f"[avs baseline tiny] fp32 card vs CPU (rtol 1e-3, atol 1e-4; losses rtol 1e-4): "
        f"max |d| {json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}; the S4 "
        f"train forward's loss and running statistics of both baselines within their bounds, "
        f"gradient cosines (whole, lowest leaf) {cosines} (>= 0.9999)")


def phase_vggish_full():
    """The VGGish front end at full width: waves (4, 5 * 16000) through
    `waveform_to_examples` on the card (float64 arithmetic) against the
    same on the CPU, |d| <= 1e-6 (1 + |ref|); then VGGish (seeded, float32)
    on the 20 examples: (4, 5, 128) embeddings, finite and >= 0. Times (CUDA
    events) of the front end and of VGGish. Returns (embeddings, numbers)."""
    from avmoe_tpu_torch.backbones.vggish import VGGish, waveform_to_examples
    from avmoe_tpu_torch.models.ave import init_parameters

    rng = np.random.RandomState(51)
    t = np.arange(BASELINE_WAVE) / 16_000.0
    waves = (0.3 * np.sin(2 * np.pi * rng.uniform(200, 3000, (BATCH, 1)) * t)
             + 0.05 * rng.randn(BATCH, BASELINE_WAVE)).astype(np.float32)
    cpu_ex = waveform_to_examples(torch.from_numpy(waves))
    w = torch.from_numpy(waves).cuda()
    ex = waveform_to_examples(w)
    torch.cuda.synchronize()
    check(tuple(ex.shape) == (BATCH, BASELINE_T, 96, 64) and ex.is_cuda,
          f"vggish examples shape {tuple(ex.shape)}")
    d = (ex.cpu().double() - cpu_ex.double()).abs()
    err = d.max().item()
    check(bool((d <= 1e-6 * (1 + cpu_ex.double().abs())).all()),
          f"vggish examples card vs CPU max |d| {err:.3e}")
    fe_ms = time_ms(lambda: waveform_to_examples(w), iters=10, warmup=2)
    model = VGGish().cuda()
    init_parameters(model, torch.Generator(device="cuda").manual_seed(52))
    x = ex.reshape(-1, 96, 64, 1)
    with torch.no_grad():
        emb = model(x).reshape(BATCH, BASELINE_T, -1)
        vgg_ms = time_ms(lambda: model(x), iters=10, warmup=2)
    check(tuple(emb.shape) == (BATCH, BASELINE_T, 128) and bool(torch.isfinite(emb).all())
          and bool((emb >= 0).all()), "vggish embeddings: shape, finite, >= 0")
    card = _card_line()
    log(f"[avs baseline] VGGish front end: waves ({BATCH}, {BASELINE_WAVE}) -> examples "
        f"{tuple(ex.shape)} on the card, float64, max |d| {err:.3e} against the CPU's; "
        f"{fe_ms:.3f} ms (CUDA events); VGGish float32 on {x.shape[0]} examples: "
        f"{vgg_ms:.3f} ms -> embeddings {tuple(emb.shape)}; {card}")
    del model
    torch.cuda.empty_cache()
    return emb, {"examples_max_abs_err": err, "frontend_ms": fe_ms, "vggish_ms": vgg_ms,
                 "examples": list(ex.shape), "card": card}


def _baseline_masks(seed: int, device):
    """(BATCH, 224, 224) first-frame masks: one random rectangle each."""
    rng = np.random.RandomState(seed)
    M = BASELINE_FRAME
    mask = np.zeros((BATCH, M, M), np.float32)
    for b in range(BATCH):
        h0, w0 = rng.randint(0, M // 2, 2)
        mask[b, h0:h0 + rng.randint(M // 8, M // 2), w0:w0 + rng.randint(M // 8, M // 2)] = 1
    return torch.from_numpy(mask).to(device)


def _events_and_wall(run, n: int):
    """Wall ms (host clock, synced) and device ms (CUDA events bracketing
    the work) of each of n calls of run: (median wall, median device)."""
    walls, dev = [], []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        dev.append(a.elapsed_time(b))
    return float(np.median(walls)), float(np.median(dev))


def phase_avs_baseline(backbone: str, audio_feature: torch.Tensor) -> dict:
    """AVSBaselineModel(backbone) at full width (PVT-v2-b5 or ResNet-50,
    channel 256, TPAVI at the four stages) in float32 on the card, seeded,
    frames (4, 5, 224, 224, 3) and VGGish embeddings (4, 5, 128): the eval
    forward (the encoder's pyramid at 56 / 28 / 14 / 7, mask logits (20,
    224, 224), feature maps and aligned audio, all finite); the S4 step's
    gradients at the seeded init (every one finite, exactly the
    `baseline_seed_init_stalls` set zero); one S4 train step (Adam over
    every parameter; DropPath on for PVT): a finite loss, every parameter
    moved but that set, every running variance moved; no kernel of the
    port launched. Wall and CUDA-event ms of the eval forward and the step,
    peak memory."""
    from avmoe_tpu_torch.config import TrainConfig
    from avmoe_tpu_torch.models.avs_baseline import AVSBaselineModel, make_avs_baseline_loss_fn
    from avmoe_tpu_torch.train.state import create_train_state
    from avmoe_tpu_torch.train.steps import make_train_step

    label = f"avs baseline {backbone}"
    counters = {**_counters(), **_train_counters()}
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    model = AVSBaselineModel(backbone, num_segments=BASELINE_T, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(61)
    imgs = torch.rand((BATCH, BASELINE_T, BASELINE_FRAME, BASELINE_FRAME, 3), generator=gen,
                      device="cuda")
    frames = BATCH * BASELINE_T
    with torch.no_grad():
        pyramid = model.encoder_backbone(imgs.reshape(frames, BASELINE_FRAME, BASELINE_FRAME, 3))
    sizes = [p.shape[1] for p in pyramid]
    check(sizes == [BASELINE_FRAME // 2 ** (i + 2) for i in range(4)] and [p.shape[-1] for p in pyramid] == list(model.encoder_backbone.widths),
          f"{label}: pyramid {[tuple(p.shape) for p in pyramid]}")
    del pyramid
    out = model(imgs, audio_feature)
    check(tuple(out["mask_logits"].shape) == (frames, BASELINE_FRAME, BASELINE_FRAME)
          and bool(torch.isfinite(out["mask_logits"]).all()), f"{label}: mask_logits")
    for i, (f, a) in enumerate(zip(out["feature_map_list"], out["a_fea_list"])):
        check(tuple(f.shape) == (frames, sizes[i], sizes[i], model.channel)
              and tuple(a.shape) == (BATCH, BASELINE_T, model.channel)
              and bool(torch.isfinite(f).all() and torch.isfinite(a).all()),
              f"{label}: stage {i} map / audio")
    del out
    eval_ms, eval_dev = _events_and_wall(lambda: model(imgs, audio_feature), 3)

    lr = TrainConfig().lr
    state = create_train_state(model, TrainConfig(accum_steps=1, lr=lr, lr_mlp=lr),
                               steps_per_epoch=100, frozen_scopes=())
    check(len(state.trainable) == len(list(model.parameters())),
          f"{label}: not every parameter trains")
    loss_fn = make_avs_baseline_loss_fn(model)
    batch = dict(images=imgs, audio_feature=audio_feature, mask=_baseline_masks(62, "cuda"))
    names = list(state.trainable)
    loss, _ = loss_fn(model, batch, gen)
    grads = torch.autograd.grad(loss, list(state.trainable.values()), allow_unused=True)
    stalls = baseline_seed_init_stalls(names)
    zero = {n for n, g in zip(names, grads) if g is None or not bool(g.any())}
    finite = all(g is None or bool(torch.isfinite(g).all()) for g in grads)
    check(finite and math.isfinite(loss.item()), f"{label}: a gradient or the loss not finite")
    check(zero == stalls, f"{label}: zero gradients beyond the W_z set "
          f"{sorted(zero - stalls)[:5]}, W_z set with a gradient {sorted(stalls - zero)[:5]}")
    del grads, loss
    start = {n: p.detach().clone() for n, p in state.trainable.items()}
    var0 = {n: b.clone() for n, b in model.named_buffers() if n.endswith("running_var")}
    step = make_train_step(loss_fn)
    state, met = step(state, batch, gen)
    torch.cuda.synchronize()
    step_loss = float(met["loss"])
    check(math.isfinite(step_loss), f"{label}: step loss {step_loss}")
    unchanged = {n for n, p in state.trainable.items() if torch.equal(p, start[n])}
    check(unchanged == stalls, f"{label}: unmoved beyond the W_z set "
          f"{sorted(unchanged - stalls)[:5]}; W_z set moved {sorted(stalls - unchanged)[:5]}")
    bufs = dict(model.named_buffers())
    check(var0 and all(not torch.equal(bufs[n], v) for n, v in var0.items()),
          f"{label}: a running variance did not move")
    del start
    step_ms, step_dev = _events_and_wall(lambda: step(state, batch, gen), 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: c.launches for k, c in counters.items()}
    check(not any(launches.values()), f"{label}: kernels launched {launches}")
    card = _card_line()
    log(f"[avs baseline] {label}: {n_params / 1e6:.2f} M parameters, float32, frames "
        f"({BATCH}, {BASELINE_T}, {BASELINE_FRAME}, {BASELINE_FRAME}, 3); pyramid {sizes}; "
        f"eval {eval_ms:.2f} ms wall, {eval_dev:.2f} ms between CUDA events "
        f"({BATCH / eval_ms * 1e3:.3f} clips/s); S4 step loss {step_loss:.5f}, "
        f"{len(names) - len(stalls)} of {len(names)} tensors moved, the {len(stalls)} of the "
        f"W_z set (and the aligned audio's projection) not; step {step_ms:.2f} ms wall, "
        f"{step_dev:.2f} ms between CUDA events ({BATCH / step_ms * 1e3:.3f} clips/s); peak "
        f"memory {peak:.2f} GiB; launches {launches}; {card}")
    del model, state, batch, imgs
    torch.cuda.empty_cache()
    return {"params_m": n_params / 1e6, "eval_ms": eval_ms, "eval_device_ms": eval_dev,
            "eval_clips_per_s": BATCH / eval_ms * 1e3, "train_step_ms": step_ms,
            "train_step_device_ms": step_dev, "train_clips_per_s": BATCH / step_ms * 1e3,
            "peak_gib": peak, "step_loss": step_loss, "moved_tensors": len(names) - len(stalls),
            "seed_init_stalled_tensors": len(stalls), "launches": launches, "card": card}


# ---------------------------------------------------------------------------
# The AVVP, AVQA and AVS drivers (cli/train_{avvp,avqa,avs}.py) in-process at
# full width in bf16: train by epoch, evaluate, keep the best checkpoint,
# test and resume
# ---------------------------------------------------------------------------


def _cli_train_report(label: str, p, got, want, steps_per_epoch: int, base_mem: int,
                      moved: bool = True, stalls=frozenset(), still=frozenset()):
    """The checks every CLI train run takes: the launches over the run as
    planned, finite losses, frozen parameters bit-identical, no jax imported,
    nothing left on the card after main returned; with `moved`, every
    trainable tensor moved but `still` (`_moved`). Returns the
    run's numbers (step wall, loader wait, a checkpoint's size and save time,
    the frozen / moved counts) and, on the host, the trainable tensors'
    values at its first step."""
    check(got == want, f"{label}: launches over the run {got}, want {want}")
    losses = [float(v) for v in p.losses]
    check(losses and all(math.isfinite(v) for v in losses), f"{label}: losses {losses}")
    n_frozen = _frozen_unchanged(label, p.state, p.initial)
    # else held over the train and resumed runs (`_cli_resume`)
    n_moved = _moved(label, p.state, p.initial, stalls, still)[0] if moved else None
    check("jax" not in sys.modules, f"{label}: jax was imported")
    save_s, size = p.saves[-1]
    start = {n: p.initial[n].cpu() for n in p.state.trainable}
    out = {"losses": losses, "loop_step_wall_ms": _loop_step_ms(p.step_starts, steps_per_epoch),
           "loader_wait_ms_per_step": float(np.mean(p.waits)) * 1e3,
           "checkpoint_gb": size / 1e9, "checkpoint_save_ms": save_s * 1e3,
           "frozen_tensors": n_frozen, "moved_tensors": n_moved}
    p.state = p.initial = None
    left = _memory_left_mib(base_mem)
    check(left < 64, f"{label}: {left:.1f} MiB still allocated after main returned")
    return out, start


def _cli_resume(label: str, mod, argv, counters, directory: str, steps_per_epoch: int,
                epochs: int, start=None, stalls=frozenset(), still=frozenset(),
                every: bool = True):
    """`--resume` to `epochs`: the restored state equals the latest checkpoint
    bit for bit, and the run takes the epochs after that checkpoint's with
    finite losses and its frozen parameters bit-identical. With `start` (the
    trainable tensors at the phase's first step), every trainable tensor has
    moved from there over the train and resumed runs, but `still` (`_moved`,
    `every`). Returns (its losses, the restore's ms, the moved tensors or
    None)."""
    from avmoe_tpu_torch.checkpoint.manager import CheckpointManager

    manager = CheckpointManager(directory)
    latest = manager.latest_step()
    saved = _saved_payload(manager)
    _, r, _, _ = _cli_run(mod, argv, counters, resume_from=saved)
    del saved
    check(r.resume_diff == [], f"{label} resume: restored state differs from step {latest}'s "
                               f"checkpoint: {r.resume_diff}")
    losses = [float(v) for v in r.losses]
    runs = epochs - latest // steps_per_epoch
    check(len(losses) == runs * steps_per_epoch and all(math.isfinite(v) for v in losses),
          f"{label} resume: from step {latest}, losses {losses}")
    _frozen_unchanged(f"{label} resume", r.state, r.initial)
    n_moved = None if start is None else _moved(f"{label} train and resume", r.state, start,
                                                stalls, still, every)[0]
    log(f"[{label}] resume: state bit-identical to step {latest}'s checkpoint (weights, BN "
        f"stats, Adam moments, acc_grads, step, updates); epochs {epochs - runs + 1} to "
        f"{epochs}: losses {[round(v, 4) for v in losses]}"
        + (f"; over the train and resumed runs {n_moved} of {len(start)} trainable tensors "
           f"moved, the {len(still)} that cannot move did not" if start is not None else ""))
    r.state = r.initial = None
    return losses, r.restores[-1] * 1e3, n_moved


def phase_avvp_cli(train_step_ms: float):
    """`avmoe_tpu_torch.cli.train_avvp.main` in-process on the full
    AVVPConfig() in bf16: train (1 epoch of 32 synthetic clips, batch 4,
    accum 2: 8 micro-steps, the F1 suite over 2 eval batches), --mode test
    on its checkpoints (the F1 suite of the best step's evaluation,
    exactly), --resume to a second epoch."""
    import shutil
    import tempfile

    from avmoe_tpu_torch.cli import train_avvp
    from avmoe_tpu_torch.config import AVVPConfig
    from avmoe_tpu_torch.moe.injection import backward_launches, kernel_launches, plan_injection

    cfg, spe = AVVPConfig(), 8
    tmp = tempfile.mkdtemp(prefix="avvp_cli_")
    argv = ["--synthetic", "--batch_size", str(BATCH), "--accum_itr", "2", "--num_workers", "4",
            "--model_save_dir", tmp]
    counters = _train_counters()
    fwd = kernel_launches(cfg.swin, cfg.htsat, cfg.injection, block_chains=False)
    per_step = {"K1": fwd["K1"], "K2": fwd["K2"],
                **backward_launches(cfg.swin, cfg.htsat, cfg.injection)}
    per_eval = {"K1": fwd["K1"], "K2": fwd["K2"], "K1b": 0, "K2b": 0}
    try:
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        best, p, got, train_s = _cli_run(train_avvp, argv + ["--epochs", "1"], counters)
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps, evals = len(p.losses), p.eval_batches
        check(steps == spe and evals == 2 and len(p.results) == 1,
              f"avvp cli: {steps} train steps, {evals} eval batches, {len(p.results)} evaluations")
        want = _run_plan(per_step, per_eval, steps, evals)
        res, _ = _cli_train_report("avvp cli", p, got, want, spe, base_mem,
                                   stalls=AVVP_CLI_STALLS)
        best_json, kept = _best_json(tmp)
        check(best_json["metric"] == best["seg_type_avg"] and best_json["step"] in kept,
              f"avvp cli: best.json {best_json}, best {best}, steps kept {kept}")
        _expert_dumps("avvp cli", tmp, len(plan_injection(cfg.swin, cfg.htsat, cfg.injection)))
        log(f"[avvp cli] train: AVVPConfig() bf16, {steps} micro-steps (accum 2), {evals} eval "
            f"batches in {train_s:.1f} s; losses {[round(v, 4) for v in res['losses']]}; seg "
            f"Type@Avg by epoch {[r['seg_type_avg'] for r in p.results]}; best.json "
            f"{best_json}, steps kept {kept}; {res['frozen_tensors']} frozen tensors "
            f"bit-identical, {res['moved_tensors']} trainable tensors moved; launches {got} "
            f"(plan {want})")

        summary, q, got_t, test_s = _cli_run(train_avvp, argv + ["--mode", "test"], counters)
        check(got_t == _run_plan(per_step, per_eval, 0, 2), f"avvp cli test: launches {got_t}")
        epoch = best_json["step"] // spe
        check(kept[-1] == best_json["step"] and summary == p.results[epoch - 1],
              f"avvp cli test: F1 suite {summary} vs epoch {epoch}'s evaluation "
              f"{p.results[epoch - 1]}")
        log(f"[avvp cli] test: the restored step {kept[-1]}'s F1 suite equals epoch {epoch}'s "
            f"evaluation in the train run, all 10 numbers ({summary}), in {test_s:.1f} s; "
            f"launches {got_t}")
        losses3, restore_ms, _ = _cli_resume("avvp cli", train_avvp,
                                             argv + ["--resume", "--epochs", "2"], counters,
                                             tmp, spe, 2)
        log(f"[time] avvp cli: median loop step wall {res['loop_step_wall_ms']:.2f} ms "
            f"(phase_avvp_train's step {train_step_ms:.2f} ms); loader wait "
            f"{res['loader_wait_ms_per_step']:.3f} ms a step; checkpoint "
            f"{res['checkpoint_gb']:.3f} GB saved in {res['checkpoint_save_ms']:.1f} ms, restored "
            f"in {restore_ms:.1f} ms; peak memory {peak:.2f} GiB")
        return {**res, "clips": BATCH, "accum_steps": 2, "train_steps": steps,
                "eval_batches": evals, "phase_train_step_ms": train_step_ms,
                "checkpoint_restore_ms": restore_ms, "peak_gib": peak, "train_run_s": train_s,
                "test_run_s": test_s, "best_seg_type_avg": best["seg_type_avg"],
                "test_f1": summary, "launches": got, "resume_losses": losses3}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


AVQA_HEADS = ("fc_a1", "fc_a2", "fc_gl", "fc1", "fc2", "fc3", "fc4")


def phase_avqa_cli(train_step_ms: float):
    """`avmoe_tpu_torch.cli.train_avqa.main` in-process on the full
    AVQAConfig() in bf16: stage A (--stage grounding, 1 epoch of 32 synthetic
    clips, batch 4 as 40 one-segment samples, accum 2: the frozen backbones'
    passes without gradient, HTS-AT's bn0 on batch statistics), then stage B
    (--stage avst --grounding_ckpt, 1 epoch with the per-type accuracy over
    2 eval batches) starting from the grafted heads, then --resume to a
    second epoch; stage B with SpecAugment and dropout off (see below)."""
    import shutil
    import tempfile

    from avmoe_tpu_torch.checkpoint.manager import CheckpointManager
    from avmoe_tpu_torch.cli import train_avqa
    from avmoe_tpu_torch.config import AVQAConfig
    from avmoe_tpu_torch.models.avqa import avqa_kernel_launches
    from avmoe_tpu_torch.models.avqa_grounding import grounding_kernel_launches
    from avmoe_tpu_torch.moe.injection import backward_launches, plan_injection

    cfg, spe = AVQAConfig(), 8
    grd, avst = tempfile.mkdtemp(prefix="avqa_grd_"), tempfile.mkdtemp(prefix="avqa_avst_")
    common = ["--synthetic", "--batch_size", str(BATCH), "--accum_itr", "2", "--num_workers",
              "4"]
    counters = _train_counters()
    g_step = {**grounding_kernel_launches(cfg), "K1b": 0, "K2b": 0}
    g_step.pop("K3")
    fwd = avqa_kernel_launches(cfg, block_chains=False)
    per_step = {"K1": fwd["K1"], "K2": fwd["K2"],
                **backward_launches(cfg.swin, cfg.htsat, cfg.injection)}
    per_eval = {"K1": fwd["K1"], "K2": fwd["K2"], "K1b": 0, "K2b": 0}
    try:
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        g_best, g, got, g_s = _cli_run(
            train_avqa, common + ["--stage", "grounding", "--epochs", "1", "--model_save_dir",
                                  grd], counters)
        g_peak = torch.cuda.max_memory_allocated() / 2**30
        check(len(g.losses) == spe and g.eval_batches == 0,
              f"avqa cli grounding: {len(g.losses)} steps, {g.eval_batches} eval batches")
        check(set(n.split(".")[0] for n in g.state.trainable) == set(AVQA_HEADS),
              f"avqa cli grounding: trainable {sorted(g.state.trainable)[:8]}")
        stats = g.state.batch_stats
        check(sorted(stats) == ["htsat.bn0.running_mean", "htsat.bn0.running_var"]
              and all(not torch.equal(b, g.initial_stats[n]) for n, b in stats.items()),
              f"avqa cli grounding: running stats {sorted(stats)} (bn0's must move)")
        g_res, _ = _cli_train_report("avqa cli grounding", g, got,
                                     _run_plan(g_step, g_step, spe, 0), spe, base_mem)
        log(f"[avqa cli] grounding: AVQAConfig() bf16, {spe} micro-steps of {BATCH * 10} "
            f"segments (accum 2) in {g_s:.1f} s; losses "
            f"{[round(v, 4) for v in g_res['losses']]}; best {g_best}; "
            f"{g_res['frozen_tensors']} frozen tensors (Swin-V2, HTS-AT) bit-identical, "
            f"{g_res['moved_tensors']} head tensors moved, bn0's running stats moved; launches "
            f"{got} ({g_step} a step)")

        donor = CheckpointManager(grd).load(map_location="cpu")["model"]
        heads = {n: t for n, t in donor.items() if n.split(".")[0] in AVQA_HEADS}
        del donor
        torch.cuda.reset_peak_memory_stats()
        argv = common + ["--model_save_dir", avst]
        # SpecAugment off in stage B: at the seeded init its zeroed stripes
        # blow the first audio site's gradients up to inf by the second
        # micro-step (no gate holds them back), in bf16 and float32, through
        # the kernels and their plain versions alike, and the first update
        # makes that site NaN, as it does in the JAX package's math
        # (tests/test_torch_cli_seed_init.py; tools/cli_seed_init_grads.py)
        with _deterministic():
            a_best, a, got, a_s = _cli_run(train_avqa, argv + ["--epochs", "1",
                                                               "--grounding_ckpt", grd],
                                           counters, graft_from=heads)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(len(heads) == 2 * len(AVQA_HEADS) and a.graft_diff == [],
              f"avqa cli avst: grafted heads differ from the grounding checkpoint's: "
              f"{a.graft_diff} ({len(heads)} tensors)")
        steps, evals = len(a.losses), a.eval_batches
        check(steps == spe and evals == 2 and len(a.results) == 1,
              f"avqa cli avst: {steps} steps, {evals} eval batches")
        summary = a.results[0]
        check(summary["overall"] == a_best and len(summary) > 1,
              f"avqa cli avst: accuracy {summary}, best {a_best}")
        # 4 Adam updates leave tensors behind two zero-initialized gates
        # (the expert gate, then gate_av) unmoved: moved is held over the
        # train and resumed runs
        res, start = _cli_train_report("avqa cli avst", a, got,
                                       _run_plan(per_step, per_eval, steps, evals), spe,
                                       base_mem, moved=False)
        _expert_dumps("avqa cli", avst, len(plan_injection(cfg.swin, cfg.htsat, cfg.injection)))
        log(f"[avqa cli] avst: AVQAConfig() bf16 from the {len(heads)} grafted head tensors "
            f"(bit-identical to the grounding checkpoint's), {steps} micro-steps, {evals} eval "
            f"batches in {a_s:.1f} s; losses {[round(v, 4) for v in res['losses']]}; accuracy "
            f"per type {summary}; {res['frozen_tensors']} frozen tensors bit-identical; "
            f"launches {got}")
        with _deterministic():
            losses2, restore_ms, res["moved_tensors"] = _cli_resume(
                "avqa cli", train_avqa, argv + ["--resume", "--epochs", "2"], counters, avst,
                spe, 2, start=start)
        log(f"[time] avqa cli: median loop step wall {res['loop_step_wall_ms']:.2f} ms "
            f"(phase_avqa_train's step {train_step_ms:.2f} ms), grounding step "
            f"{g_res['loop_step_wall_ms']:.2f} ms; loader wait "
            f"{res['loader_wait_ms_per_step']:.3f} ms a step (grounding "
            f"{g_res['loader_wait_ms_per_step']:.3f}); checkpoint {res['checkpoint_gb']:.3f} GB "
            f"saved in {res['checkpoint_save_ms']:.1f} ms, restored in {restore_ms:.1f} ms "
            f"(grounding {g_res['checkpoint_gb']:.3f} GB in {g_res['checkpoint_save_ms']:.1f} "
            f"ms); peak memory {peak:.2f} GiB (grounding {g_peak:.2f})")
        return {**res, "clips": BATCH, "accum_steps": 2, "train_steps": steps,
                "eval_batches": evals, "phase_train_step_ms": train_step_ms,
                "checkpoint_restore_ms": restore_ms, "peak_gib": peak, "train_run_s": a_s,
                "accuracy": summary, "launches": got, "resume_losses": losses2,
                "grounding": {k: g_res[k] for k in ("losses", "loop_step_wall_ms",
                                                    "loader_wait_ms_per_step", "checkpoint_gb",
                                                    "checkpoint_save_ms")}
                | {"peak_gib": g_peak, "run_s": g_s, "launches_per_step": g_step}}
    finally:
        shutil.rmtree(grd, ignore_errors=True)
        shutil.rmtree(avst, ignore_errors=True)


@contextlib.contextmanager
def _param_grad_launches():
    """Counts K1b's launches with dbias and K2b's with the weight gradients
    while it is open (the wrappers the kernels' autograd Functions call are
    swapped for counting ones)."""
    import avmoe_tpu_torch.kernels.mlp_block as mb
    import avmoe_tpu_torch.kernels.window_attention as wa

    counts = {"K1b dbias": 0, "K2b weights": 0}
    k1b, k2b = wa.window_attention_bwd, mb.mlp_block_bwd

    def k1b_counted(*args, **kwargs):
        n = k1b.launches
        out = k1b(*args, **kwargs)
        counts["K1b dbias"] += (k1b.launches - n) * bool(kwargs.get("bias_grad"))
        return out

    def k2b_counted(*args, **kwargs):
        n = k2b.launches
        out = k2b(*args, **kwargs)
        counts["K2b weights"] += (k2b.launches - n) * (kwargs.get("a1") is not None)
        return out

    wa.window_attention_bwd, mb.mlp_block_bwd = k1b_counted, k2b_counted
    try:
        yield counts
    finally:
        wa.window_attention_bwd, mb.mlp_block_bwd = k1b, k2b


def phase_avs_cli(train_step_ms: float):
    """`avmoe_tpu_torch.cli.train_avs.main` in-process: S4 on the full
    AVSConfig() in bf16 (1 epoch of 16 synthetic clips, batch 4, accum 1: 4
    steps in which HTS-AT trains, 2 eval batches), --mode test
    --save_pred_mask (a PNG a mask evaluated, the best step's mIoU and
    F-measure exactly); then MS3 at the tiny
    config on the card (its full-width step is phase_avs_train's), with
    --resume to a second epoch there (the other CLIs resume at full width;
    S4's full-width checkpoint is restored by --mode test)."""
    import shutil
    import tempfile

    from avmoe_tpu_torch.cli import train_avs
    from avmoe_tpu_torch.config import AVSConfig, ms3_config, tiny_avs_config
    from avmoe_tpu_torch.models.avs import avs_backward_launches, avs_kernel_launches
    from avmoe_tpu_torch.moe.injection import plan_injection

    cfg, spe = AVSConfig(), 4
    tmp, tiny = tempfile.mkdtemp(prefix="avs_cli_"), tempfile.mkdtemp(prefix="avs_ms3_cli_")
    argv = ["--setting", "s4", "--synthetic", "--train_batch_size", str(BATCH), "--accum_itr",
            "1", "--num_workers", "4", "--model_save_dir", tmp]
    counters = _train_counters()
    fwd = avs_kernel_launches(cfg, block_chains=False)
    per_step = {"K1": fwd["K1"], "K2": fwd["K2"], **avs_backward_launches(cfg)}
    per_eval = {"K1": fwd["K1"], "K2": fwd["K2"], "K1b": 0, "K2b": 0}
    htsat_blocks = sum(cfg.htsat.depths)
    try:
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with _param_grad_launches() as grads:
            best, p, got, train_s = _cli_run(train_avs, argv + ["--max_epoches", "1"], counters)
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps, evals = len(p.losses), p.eval_batches
        check(steps == spe and evals == 2 and len(p.results) == 1,
              f"avs cli: {steps} train steps, {evals} eval batches")
        want_grads = {"K1b dbias": steps * htsat_blocks, "K2b weights": steps * htsat_blocks}
        check(grads == want_grads, f"avs cli: parameter-gradient launches {grads}, want "
                                   f"{want_grads} (every HTS-AT block a step)")
        htsat = [n for n in p.state.trainable if n.startswith("encoder.htsat.")]
        check(len(htsat) > 0 and all(not torch.equal(p.state.trainable[n], p.initial[n])
                                     for n in htsat), "avs cli: an HTS-AT weight did not move")
        n_htsat = len(htsat)
        # at the recipe's lr S4 collapses to a constant loss within a few
        # updates (tools/s4_train_curve.py: float32 through the plain
        # versions too), so tensors behind two zero gates may never get a
        # gradient: HTS-AT's moving is held, and the tensors that cannot move
        still = avs_seed_init_stalls(cfg, p.state.trainable)
        n_moved = _moved("avs cli", p.state, p.initial, still=still, every=False)[0]
        res, _ = _cli_train_report("avs cli", p, got, _run_plan(per_step, per_eval, steps, evals),
                                   spe, base_mem, moved=False)
        res["moved_tensors"] = n_moved
        best_json, kept = _best_json(tmp)
        check(best_json["metric"] == best and best_json["step"] in kept,
              f"avs cli: best.json {best_json}, best {best}, steps kept {kept}")
        n_sources = sum(len(f) for _, _, f in os.walk(os.path.join(tmp, "sources")))
        check(os.path.isfile(os.path.join(tmp, "sources", "csrc", "mlp_block.cu"))
              and os.path.isfile(os.path.join(tmp, "sources", "cli", "train_avs.py")),
              "avs cli: the sources were not archived")
        _expert_dumps("avs cli", tmp, len(plan_injection(cfg.swin, cfg.htsat, cfg.injection)))
        log(f"[avs cli] train: S4 AVSConfig() bf16, HTS-AT trainable, {steps} micro-steps "
            f"(accum 1), {evals} eval batches in {train_s:.1f} s; losses "
            f"{[round(v, 4) for v in res['losses']]}; (mIoU, F) by epoch {p.results}; best.json "
            f"{best_json}, steps kept {kept}; {n_sources} source files archived; "
            f"{res['frozen_tensors']} frozen tensors bit-identical, the {n_htsat} of HTS-AT "
            f"all moved, {res['moved_tensors']} trainable tensors moved, the {len(still)} that "
            f"cannot move did not; launches {got}, with parameter gradients {grads}")

        miou, q, got_t, test_s = _cli_run(train_avs, argv + ["--mode", "test",
                                                             "--save_pred_mask"], counters)
        masks = sorted(os.listdir(os.path.join(tmp, "pred_masks")))
        epoch = best_json["step"] // spe
        check(len(masks) == 2 * BATCH * cfg.num_segments and got_t == _run_plan(
            per_step, per_eval, 0, 2), f"avs cli test: {len(masks)} masks, launches {got_t}")
        check(kept[-1] == best_json["step"] and miou == best_json["metric"]
              and q.results[0] == p.results[epoch - 1],
              f"avs cli test: (mIoU, F) {q.results[0]} vs epoch {epoch}'s {p.results[epoch - 1]}")
        log(f"[avs cli] test: the restored step {kept[-1]}'s (mIoU, F) {q.results[0]} equal "
            f"epoch {epoch}'s evaluation in the train run; {len(masks)} mask PNGs saved (8 clips "
            f"x 5 frames) in {test_s:.1f} s; launches {got_t}")
        restore_ms = q.restores[-1] * 1e3

        # MS3 at the tiny config, float32, on the card: 8 clips, 4 micro-steps
        # and Adam updates
        ms3 = ms3_config(tiny_avs_config())
        margv = ["--setting", "ms3", "--tiny", "--no-bf16", "--synthetic", "--train_batch_size",
                 "2", "--accum_itr", "1", "--num_workers", "2", "--model_save_dir", tiny]
        m_fwd = avs_kernel_launches(ms3, block_chains=False)
        m_step = {"K1": m_fwd["K1"], "K2": m_fwd["K2"], **avs_backward_launches(ms3)}
        m_eval = {"K1": m_fwd["K1"], "K2": m_fwd["K2"], "K1b": 0, "K2b": 0}
        base_mem = torch.cuda.memory_allocated()
        m_best, m, got_m, m_s = _cli_run(train_avs, margv + ["--max_epoches", "1"], counters)
        m_still = avs_seed_init_stalls(ms3, m.state.trainable)
        m_res, _ = _cli_train_report("avs ms3 tiny cli", m, got_m,
                                     _run_plan(m_step, m_eval, 4, 2), 4, base_mem, still=m_still)
        m_test, _, _, _ = _cli_run(train_avs, margv + ["--mode", "test"], counters)
        check(m_test == m_best, f"avs ms3 tiny cli: test mIoU {m_test} vs best {m_best}")
        m_resume, _, _ = _cli_resume("avs ms3 tiny cli", train_avs,
                                     margv + ["--resume", "--max_epoches", "2"], counters, tiny,
                                     4, 2)
        log(f"[avs cli] MS3 tiny float32 on the card: 4 micro-steps, 2 eval batches in "
            f"{m_s:.1f} s, losses {[round(v, 4) for v in m_res['losses']]}; launches {got_m}; "
            f"{m_res['moved_tensors']} trainable tensors moved, the {len(m_still)} that cannot "
            f"move did not; test mIoU {m_test} == best")
        log(f"[time] avs cli: median loop step wall {res['loop_step_wall_ms']:.2f} ms "
            f"(phase_avs_train's S4 step {train_step_ms:.2f} ms); loader wait "
            f"{res['loader_wait_ms_per_step']:.3f} ms a step; checkpoint "
            f"{res['checkpoint_gb']:.3f} GB saved in {res['checkpoint_save_ms']:.1f} ms, restored "
            f"in {restore_ms:.1f} ms; peak memory {peak:.2f} GiB")
        return {**res, "setting": "s4", "clips": BATCH, "accum_steps": 2, "train_steps": steps,
                "eval_batches": evals, "phase_train_step_ms": train_step_ms,
                "checkpoint_restore_ms": restore_ms, "peak_gib": peak, "train_run_s": train_s,
                "test_run_s": test_s, "miou_fmeasure_by_epoch": p.results,
                "test_miou": miou, "masks_saved": len(masks), "launches": got,
                "param_grad_launches": grads, "seed_init_stalled_tensors": len(still),
                "ms3_tiny_losses": m_res["losses"], "ms3_tiny_resume_losses": m_resume}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(tiny, ignore_errors=True)


def _kernel_entry(name: str, source: str, replaces: str, launches: int, err: float, tot,
                  library_ms, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": tot["ms"],
            "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes"] / HBM_BYTES_PER_S
            >= tot["ops"] / BF16_FLOPS else "operations",
            "library_ms": library_ms, **extra}


def _legacy_launches(legacy, kernel: str) -> dict:
    """The legacy models' launches of `kernel` (a forward's, or a train
    step's for K1b / K2b) under mmil_v1_launches / lavish_launches."""
    key = "launches_per_step" if kernel.endswith("b") else "launches_per_forward"
    return {("mmil_v1" if name == "v1" else name) + "_launches": legacy[name][key][kernel]
            for name in LEGACY}


def _param_grads_entry(err: float, tot) -> dict:
    """K1b's dbias or K2b's weight gradients at the S4 step's shapes: errors,
    times with and without them, per S4 step."""
    return {"where": "AVS S4 step, batch 4, HTS-AT shapes", "launches": tot["launches"],
            "max_abs_err": err, "max_abs_err_f32": tot["f32_err"], "ms": tot["ms"],
            "without_ms": tot["frozen_ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": "bytes" if tot["bytes"] / HBM_BYTES_PER_S
            >= tot["ops"] / BF16_FLOPS else "operations",
            "library_ms": tot.get("library_ms"),
            **({"cublas_weight_products_ms": tot["products_ms"]} if "products_ms" in tot
               else {})}


def main():
    t0 = time.perf_counter()

    def done(phase: str) -> None:
        log(f"[phase] {phase} done at {time.perf_counter() - t0:.1f} s")

    phase_card()
    phase_build()
    done("build")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k1_err, k1_tot = phase_k1(gen)
    k2_err, k2_tot = phase_k2(gen)
    k3_err, k3_tot = phase_k3(gen)
    done("K1, K2, K3")
    phase_tiny()
    launches, fwd_ms, fwd_profs, model = phase_full()
    done("AVE eval")
    k1b_err, k1b_tot = phase_k1b(gen)
    k2b_err, k2b_tot = phase_k2b(gen)
    done("K1b, K2b")
    phase_train_tiny()
    train, step_ms, step_prof = phase_train(model)
    done("AVE train")
    fused = phase_fused_moe(model, fwd_profs["default path"], step_prof)
    done("AVE fused combine")
    tsne = phase_tsne(model)
    phase_dryrun()
    done("t-SNE, data-parallel dry run")
    convert = phase_convert(model)
    audio_stats = phase_audio_stats()
    done("AVE convert, audio stats")
    del model
    torch.cuda.empty_cache()
    phase_ave_heads_tiny()
    flavor = phase_ave_flavor()
    torch.cuda.empty_cache()
    ave_cli = phase_ave_cli(step_ms)
    done("AVE heads, flavor, CLI")
    legacy = {}
    for name in LEGACY:
        legacy[name] = phase_legacy(name, gen)
        done(f"{name} eval, train")
    for name in LEGACY:
        legacy[f"{name}_cli"] = phase_legacy_cli(name, legacy[name]["train_step_ms"])
        done(f"{name} CLI")
    avvp_tiny_k3 = phase_avvp_tiny()
    phase_avvp_gram(gen)
    avvp, avvp_fwd_ms, avvp_prof, avvp_model = phase_avvp_full()
    done("AVVP eval")
    avvp_train, avvp_step_ms, avvp_step_prof = phase_avvp_train(avvp_model)
    done("AVVP train")
    del avvp_model
    torch.cuda.empty_cache()
    _, avqa_k3_tot = phase_k3(gen, avqa_k3_shapes(), "avqa K3")
    phase_avqa_tiny()
    avqa, avqa_fwd_ms, avqa_prof, avqa_neg_ms, avqa_neg_prof, avqa_cos, avqa_model = \
        phase_avqa_full()
    done("AVQA eval")
    avqa_train, avqa_step_ms, avqa_peak, avqa_step_prof = phase_avqa_train(avqa_model)
    done("AVQA train")
    del avqa_model
    torch.cuda.empty_cache()
    avs_kern, avs_k3_rel = phase_avs_kernels(gen)
    k1b_bias_err, k1b_bias = phase_k1b_bias(gen)
    k2b_params_err, k2b_params = phase_k2b_params(gen)
    done("AVS kernels")
    phase_avs_tiny()
    avs, avs_fwd_ms, avs_prof, avs_tpavi, avs_cos, avs_metrics, avs_s4, avs_ms3 = \
        phase_avs_full()
    done("AVS eval")
    avs_train, avs_step_ms, avs_peak, avs_step_prof, s4_train = phase_avs_train(avs_s4,
                                                                                avs_ms3)
    done("AVS train")
    del avs_s4, avs_ms3
    torch.cuda.empty_cache()
    phase_avs_baseline_tiny()
    emb, baseline = phase_vggish_full()
    baseline = {"clips": BATCH, "frames_per_clip": BASELINE_T, "frame_px": BASELINE_FRAME,
                "dtype": "float32", "vggish": baseline}
    for backbone in ("pvt", "resnet"):
        baseline[backbone] = phase_avs_baseline(backbone, emb)
        done(f"AVS baseline {backbone}")
    del emb
    avvp_cli = phase_avvp_cli(avvp_step_ms)
    done("AVVP CLI")
    avqa_cli = phase_avqa_cli(avqa_step_ms)
    done("AVQA CLI")
    avs_cli = phase_avs_cli(s4_train["step_ms"])
    done("AVS CLI")
    default, chain = launches["default path"], launches["chain path"]
    log(f"[time] per batch-{BATCH} forward: K1 {k1_tot['ms']:.3f} ms over {default['K1']} calls "
        f"(bound {k1_tot['bound_ms']:.3f}), K2 {k2_tot['ms']:.3f} ms over {default['K2']} calls "
        f"(bound {k2_tot['bound_ms']:.3f}), whole default forward {fwd_ms['default path']:.3f} "
        f"ms; K3 {k3_tot['ms']:.3f} ms over {chain['K3']} calls (bound "
        f"{k3_tot['bound_ms']:.3f}), whole chain forward {fwd_ms['chain path']:.3f} ms")
    log(f"[time] per batch-{BATCH} train step: K1b {k1b_tot['ms']:.3f} ms over {train['K1b']} "
        f"calls (bound {k1b_tot['bound_ms']:.3f}), K2b {k2b_tot['ms']:.3f} ms over "
        f"{train['K2b']} calls (bound {k2b_tot['bound_ms']:.3f}), whole step {step_ms:.3f} ms")
    log(json.dumps({"avvp": {
        "clips": BATCH, "eval_ms": avvp_fwd_ms, "eval_clips_per_s": BATCH / avvp_fwd_ms * 1e3,
        "eval_device_busy_ms": avvp_prof[0], "eval_idle_share": avvp_prof[1],
        "eval_idle_share_profiled": avvp_prof[2],
        "train_step_ms": avvp_step_ms, "train_clips_per_s": BATCH / avvp_step_ms * 1e3,
        "train_device_busy_ms": avvp_step_prof[0], "train_idle_share": avvp_step_prof[1],
        "train_idle_share_profiled": avvp_step_prof[2],
        "launches_per_forward": avvp,
        "launches_per_step": avvp_train}}))
    dp, cp = avqa_prof["default path"], avqa_prof["chain path"]
    log(json.dumps({"avqa": {
        "clips": BATCH, "eval_ms": avqa_fwd_ms["default path"],
        "eval_clips_per_s": BATCH / avqa_fwd_ms["default path"] * 1e3,
        "eval_device_busy_ms": dp[0], "eval_idle_share": dp[1], "eval_idle_share_profiled": dp[2],
        "chain_eval_ms": avqa_fwd_ms["chain path"], "chain_eval_device_busy_ms": cp[0],
        "chain_eval_idle_share": cp[1],
        "negative_pass_ms": avqa_neg_ms["default path"],
        "chain_negative_pass_ms": avqa_neg_ms["chain path"],
        "negative_pass_device_busy_ms": avqa_neg_prof[0],
        "train_step_ms": avqa_step_ms, "train_clips_per_s": BATCH / avqa_step_ms * 1e3,
        "train_peak_gib": avqa_peak, "train_device_busy_ms": avqa_step_prof[0],
        "train_idle_share": avqa_step_prof[1], "train_idle_share_profiled": avqa_step_prof[2],
        "bf16_vs_f32_cosines": avqa_cos,
        "launches_per_forward": avqa["default path"],
        "chain_launches_per_forward": avqa["chain path"],
        "launches_per_step": avqa_train}}))
    dp, cp = avs_prof["default path"], avs_prof["chain path"]
    log(json.dumps({"avs": {
        "clips": BATCH, "frames_per_clip": 5, "eval_ms": avs_fwd_ms["default path"],
        "eval_clips_per_s": BATCH / avs_fwd_ms["default path"] * 1e3,
        "eval_device_busy_ms": dp[0], "eval_idle_share": dp[1], "eval_idle_share_profiled": dp[2],
        "chain_eval_ms": avs_fwd_ms["chain path"], "chain_eval_device_busy_ms": cp[0],
        "chain_eval_idle_share": cp[1],
        "tpavi_ms": avs_tpavi[0], "tpavi_device_busy_ms": avs_tpavi[1],
        "train_setting": "ms3", "train_step_ms": avs_step_ms,
        "train_clips_per_s": BATCH / avs_step_ms * 1e3,
        "train_peak_gib": avs_peak, "train_device_busy_ms": avs_step_prof[0],
        "train_idle_share": avs_step_prof[1], "train_idle_share_profiled": avs_step_prof[2],
        "bf16_vs_f32_cosines": avs_cos, "metrics": avs_metrics,
        "launches_per_forward": avs["default path"],
        "chain_launches_per_forward": avs["chain path"],
        "launches_per_step": avs_train,
        "s4_train_step_ms": s4_train["step_ms"],
        "s4_train_clips_per_s": BATCH / s4_train["step_ms"] * 1e3,
        "s4_train_peak_gib": s4_train["peak"], "s4_train_device_busy_ms": s4_train["prof"][0],
        "s4_train_idle_share": s4_train["prof"][1],
        "s4_train_idle_share_profiled": s4_train["prof"][2],
        "s4_launches_per_step": s4_train["launches"]}}))
    log(json.dumps({"ave_fused_moe": fused, "tsne": tsne}))
    log(json.dumps({"ave_legacy": legacy}))
    log(json.dumps({"avs_baseline": baseline}))
    log(json.dumps({"ave_cli": ave_cli, "ave_scv2_base": flavor, "avvp_cli": avvp_cli,
                    "avqa_cli": avqa_cli, "avs_cli": avs_cli, "convert": convert,
                    "audio_stats": audio_stats}))
    by_K = (k3_tot["rel_by_K"], avqa_k3_tot["rel_by_K"], avs_k3_rel)
    k3_rel = {K: max(d.get(K, 0.0) for d in by_K) for K in sorted(set().union(*by_K))}
    kernels = [
        _kernel_entry("window_attention", "avmoe_tpu_torch/csrc/window_attention.cu",
                      "experiments/pallas/window_attn.py:55", default["K1"], k1_err, k1_tot,
                      k1_tot["library_ms"], avvp_launches=avvp["K1"],
                      **_legacy_launches(legacy, "K1"),
                      avqa_launches=avqa["default path"]["K1"],
                      avs_launches=avs["default path"]["K1"], avs_shapes=avs_kern["K1"]),
        # the TPU kernel has no backward (JAX differentiates its XLA
        # attention): K1b is the backward of K1's contract; library: the
        # backward of scaled_dot_product_attention; times per train step
        _kernel_entry("window_attention_bwd", "avmoe_tpu_torch/csrc/window_attention_bwd.cu",
                      "experiments/pallas/window_attn.py:55", train["K1b"], k1b_err, k1b_tot,
                      k1b_tot["library_ms"], backward_of="window_attention",
                      max_rel_err=k1b_tot["max_rel_err"], avvp_launches=avvp_train["K1b"],
                      **_legacy_launches(legacy, "K1b"),
                      avqa_launches=avqa_train["K1b"], avs_launches=avs_train["K1b"],
                      avs_s4_launches=s4_train["launches"]["K1b"], avs_shapes=avs_kern["K1b"],
                      param_grads=_param_grads_entry(k1b_bias_err, k1b_bias)),
        # no PyTorch call computes the block; its two cuBLAS products alone
        # (no GELU, LN or residual) are a yardstick under a key of their own
        _kernel_entry("mlp_block", "avmoe_tpu_torch/csrc/mlp_block.cu",
                      "experiments/pallas/fused_block.py:315", default["K2"], k2_err, k2_tot,
                      None, products_ms=k2_tot["products_ms"],
                      cublas_products_only_ms=k2_tot["cublas_ms"], avvp_launches=avvp["K2"],
                      **_legacy_launches(legacy, "K2"),
                      avqa_launches=avqa["default path"]["K2"],
                      avqa_chain_launches=avqa["chain path"]["K2"],
                      avs_launches=avs["default path"]["K2"],
                      avs_chain_launches=avs["chain path"]["K2"], avs_shapes=avs_kern["K2"]),
        _kernel_entry("mlp_block_bwd", "avmoe_tpu_torch/csrc/mlp_block.cu",
                      "experiments/pallas/fused_block.py:315", train["K2b"], k2b_err, k2b_tot,
                      None, backward_of="mlp_block", products_ms=k2b_tot["products_ms"],
                      cublas_products_only_ms=k2b_tot["cublas_ms"],
                      avvp_launches=avvp_train["K2b"], avqa_launches=avqa_train["K2b"],
                      **_legacy_launches(legacy, "K2b"),
                      avs_launches=avs_train["K2b"], avs_s4_launches=s4_train["launches"]["K2b"],
                      avs_shapes=avs_kern["K2b"],
                      param_grads=_param_grads_entry(k2b_params_err, k2b_params)),
        _kernel_entry("block_chain", "avmoe_tpu_torch/csrc/block_chain.cu",
                      "experiments/pallas/fused_block.py:237", chain["K3"], k3_err, k3_tot,
                      None, avvp_launches=avvp["K3"], avvp_tiny_chain_launches=avvp_tiny_k3,
                      avqa_chain_launches=avqa["chain path"]["K3"],
                      avs_chain_launches=avs["chain path"]["K3"], bf16_rel_err_by_K=k3_rel,
                      avs_shapes=avs_kern["K3"]),
    ]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
