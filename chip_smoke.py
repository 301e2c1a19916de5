#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (dprf_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

It drives the port's main paths through the CLI a user calls, on the
card, and holds every kernel against its plain PyTorch version:

1. the card: name, device count, power limit, SM count and clock;
2. builds the mask kernel (csrc/mask.cu, every core x compare mode), the
   rule kernel (csrc/rules.cu, csrc/rules_nested.cu, csrc/rules_group.cu,
   csrc/rules_wide.cu: every core and tail), the PMKID and KDF kernels
   (csrc/pbkdf2.cu), the bcrypt kernels (csrc/bcrypt.cu), the ext,
   Keccak, Kerberos, 7-Zip and PDF kernels (csrc/ext.cu, csrc/keccak.cu,
   csrc/krb5.cu, csrc/sevenzip.cu, csrc/pdf.cu) from the checkout's
   sources, one nvcc each, all at once, and prints nvcc's
   register / shared memory / spill lines and a SASS census of each
   instantiation, each mask, ext, keccak and bcrypt kernel held to its
   slice K2 pin (``CENSUS_K2``), each rule instantiation to its slice K3
   pin (``CENSUS_K3``; none of them with a stack frame or a spill);
3. holds each instantiation against its plain version on the card at a
   batch of 2^24, with exact equality of the hit count, the sorted hit
   lanes and, for the multi-target compare, the table positions and
   n_maybe: md5 one target in five cases (first lane, last valid lane
   of a partial batch, no hit, ?a^8 from a random base, hit capacity
   0); ntlm, sha1, sha256 one target at the first lane, the last valid
   lane of a partial batch and with no hit; md5, ntlm, sha1, sha256 at 1,000 targets with hits
   at the first lane, two in one warp and the last valid lane of a
   partial batch, and with no hit; md5 at the largest shared memory a
   block takes (55 positions, 8,192 targets), where fewer blocks fit on
   an SM.  Slice K2's runs of lanes: hits on both sides of a carry of
   position L - 2 into L - 3 (two runs of two periods), a window offset
   no run length divides and n_valid inside a run, for md5 and ntlm
   (one target, the Bloom sets, the probe), the 55-position mask, a
   wide core (sha512) and md5(md5).  A worker with hit capacity 0
   recovers its hit by the oracle rescan;
4. config 1: cracks md5("zzzzzz") -- the last index of ?l^6, so the
   whole keyspace is swept -- with ``crack --device cuda``;
5. config 2 at full width: 1,000 NTLM targets under ?a^7 -- 8 planted
   in a window of 2^32 candidates (--skip S --limit 2^32) and 992
   fillers no candidate of the mask can reach -- with ``crack --device
   cuda``; checks all 8 found, the potfile, the Bloom survivors;
6. the other instantiations end to end: ntlm with one target, md5 at
   1,000 targets, sha1 and sha256 with one target and 1,000, each over
   a 2^28-candidate window of ?a^7 through the CLI.

   Every path of phases 4-6 runs with the launch counts set to 0 just
   before it and read just after: its own kernel must have launched
   once per batch the worker dispatched, and no other;
7. times every instantiation per launch with CUDA events over 0.4 s of
   launches, the SM clock sampled meanwhile (nvidia-smi), beside its
   parent time (``PARENT_MS``), the bound at the card's top clock and at
   the sampled one, the plain version for one launch; and the CLI's
   ``bench``;
8. the rule kernel against its plain version, each core at 2^24
   candidates a launch (2^18 words of the reference bench's synthetic
   list x best64), with exact equality of the count and the hit lanes:
   hits at word 0 under rule 0, at the last valid word of a partial
   window under the 8-op rule, at a window that starts at an odd word,
   both lanes of the "'7" / "]" pair, and a candidate that rejects
   (growth past max_len) never hits.  Then every opcode the kernel
   takes (``RULES_ALL_OPS``) for each core at max_len 16 and 55 (ntlm
   16 and 27) over ``RULE_WORDS`` and a random word of every length up to
   max_len, a window cut mid-warp, exact equality of the count and the
   lanes: each rule alone with a target of each length class of its
   candidates (0, 1, 3-5, 15-17, max_len - 1, max_len), then all the
   rules as one run of a thread with a target a rule;
9. config 3 at full width: the reference bench's 2^20 synthetic 8-letter
   words x best64 (67,108,864 candidates) with ``crack --device cuda
   --engine sha256 -a wordlist --rules best64``: an unreachable target
   (a full sweep) and a target planted at the last word under a
   four-op rule; then md5, ntlm and sha1 over 2^16 words.  Each path
   runs with the launch counts set to 0 just before it and read just
   after;
10. times each rule instantiation per launch at 2^24, its plain version
    and its bound;
11. the PMKID kernel (csrc/pbkdf2.cu) against its plain version at 16
    iterations over 2^16 lanes of ?l^8, with exact equality of the hit
    set (lane, target): a hit at the first lane, at the last valid lane
    of a partial batch, two targets of one ESSID hit by one lane, two
    ESSIDs, no hit, and a worker with hit capacity 0 that recovers its
    hit by the oracle rescan; then at 4096 iterations, three lanes
    planted with hashlib in a 2^20 window;
12. config 5 at full width: ``crack --device cuda --engine wpa2-pmkid
    ?l^8`` at 4096 iterations over a window of CONFIG5_WINDOW
    candidates (--skip S --limit W; the whole keyspace, 26^8, would
    take a day), a target planted at the window's last index and one no
    candidate reaches (the reference bench's line), with the launch
    counts set to 0 just before it and read just after: only the PMKID
    kernel, once per batch;
13. the bcrypt kernels (csrc/bcrypt.cu) against their plain version on
    one wave of candidates and on a batch whose last block is partial:
    setup + advance(1) + finish, exact equality of P, S, the digest
    words and the hits; then the kernels' whole
    chain at cost 4 and 5 against the pure-Python oracle, the OpenBSD
    $2a$05 vectors included;
14. config 4 at full width: ``crack --device cuda --engine bcrypt -a
    wordlist`` over the reference bench's 4,096 synthetic 8-letter words
    at cost 12: a target no word reaches (the whole sweep) and one
    planted at the last word (its line made by the oracle in a
    background process started in phase 1), the launch counts of
    setup / advance / finish held to the batches and the chunking; then
    the mask worker: ``crack --engine bcrypt ?l?l?l`` at cost 4, targets
    at the first index and at the last valid lane of a partial batch;
15. times the PMKID kernel and the bcrypt kernels with CUDA events
    beside their bounds (ops/opcount.py), their plain versions and
    bcrypt's parent times; the cost loop at the parent's wave (4,224
    candidates) and at this one, the SM clock sampled meanwhile: ms a
    cost round, ps a candidate-round, cycles a Feistel round;
16. builds csrc/ext.cu with the others (its 14 instantiations of the
    mask kernel template: the six nested chains and mysql41, one target
    and multi; and the salted kernel of csrc/salted.cuh, md5/sha1/sha256
    x $pass.$salt / $salt.$pass, a group of targets a launch) and holds
    each against its plain version at 2^24: every nested chain at one
    target (first lane, last valid lane of a partial batch, no hit) and
    at 1,000 targets (hits at lanes 0, 64, 65 and the last valid lane,
    one just past it; no hit); every salted core over a target of every
    salt length 0..32, grouped as the worker groups them (one ps group
    of 33; 33 sp groups), hits at the first lane, the last valid lane of
    a partial batch and a random lane, one just past the valid lanes,
    the count, the (lane, target) pairs and the per-target counts
    equal; md5-ps at phase 18's group of 256 targets (salts of 0..32
    bytes, plants at target positions 0 and past 200: the first lane,
    the last valid lane, two targets on one random lane, one past the
    valid lanes), its hits the plants, and against its plain version on
    N_CHECK_TARGETS of them, the planted ones; a worker's group of two whose hits fill its buffer of
    a slot a target (no rescan), and whose one-slot buffer overflows
    (the unrecorded target rescanned alone).  The build phase fails on any
    instantiation with a stack frame (local memory) and prints, beside
    each earlier mask and rule instantiation, whether its registers and
    SASS count are those it compiled to before csrc/mask_kernel.cuh took
    the kernel body out of csrc/mask.cu, and beside each grouped kernel
    its pin (``CENSUS_GROUPED``);
17. nested at full width: ``crack --device cuda --engine 'md5(md5)'
    ?a^7`` with 1,000 targets (8 planted, 992 fillers) over a 2^32
    window, config 2's shape for hashcat 2600; then mysql41 on one
    target planted at the last index of the whole ?l^6;
18. salted at full width: ``crack --device cuda --engine md5-ps ?l^6``
    against 1,000 ``hexdigest:salt`` targets, each with its own
    alphanumeric salt of 2-32 bytes, eight planted (one at the
    keyspace's last index), every target swept in full (one launch per
    group of up to 256 targets and batch: 4 x 19); the host's own time
    per launch; then sha1-sp, sha256-ps, md5-sp, sha256-sp, postgres,
    ldap-ssha and oracle11, one target each, over the whole ?l^6;
19. the other nested instantiations through the CLI over 2^28 windows
    of ?a^7.  Every path of phases 17-19 runs with the launch counts of
    every kernel set to 0 just before it and read just after: its own
    instantiation launched once per batch (per group and batch for a
    salted core), no other;
20. times every ext instantiation per launch with CUDA events beside its
    bound (ops/opcount.nested_ops, salted_ops), its plain version on
    the same inputs (a group of 256 on N_CHECK_TARGETS of its targets,
    the kernel timed there too) and, for a nested chain, its parent time
    and the SM clock sampled over the phase; a salted core at the group
    its main path launches (md5-ps: 256 targets; the others: one), then
    per 2^24 hashes at groups of 1 and 256;
21. builds the 64-bit cores with the others -- sha512 and sha384 in
    csrc/mask.cu (4 instantiations), the Keccak kernel csrc/keccak.cu (8:
    rates 144, 136, 104, 72 x one target / multi; sha3-N and keccak-N
    share one) -- fails on any of them with a stack frame, and holds each
    against its plain version at 2^24 (the plain 64-bit versions take
    ~18 GiB there): one target at the first lane, at the last valid lane
    of a partial batch, with no hit, with hit capacity 0 and at the
    longest mask the core takes (111 positions for sha512/384; 143, 135,
    103, 71 for the Keccak rates); 1,000 targets with hits at lanes 0,
    64, 65 (two in one warp) and the last valid lane, one just past it,
    and with no hit; 8,192 targets at the longest mask, where the
    block's shared memory passes 48 KB and the launch raises its limit;
22. the slice end to end through ``crack --device cuda``: sha512, sha384,
    sha3-256 and keccak-256 with one target at the last index of ?l^6
    (the whole keyspace swept) and with 1,000 targets, 8 planted, over a
    2^32 window of ?a^7 (config 2's shape); sha3-224/384/512 with one
    planted target and keccak-224/384/512 with one planted among 1,000,
    each over a 2^28 window.  Every path runs with every launch count
    set to 0 just before it and read just after: its own instantiation
    launched once per batch, no other;
23. times each new instantiation per launch beside its bound
    (ops/opcount.ops_per_candidate), its plain version, its parent time
    and the SM clock sampled over the phase;
24. builds the Kerberos RC4 kernel csrc/krb5.cu with the others, and
    csrc/pbkdf2.cu with its second entry, the KDF kernel; fails on
    either with a stack frame, and if pmkid's registers or SASS count
    moved (``PMKID_BEFORE``); then holds the krb5 kernel against its
    plain version at 2^24 candidates of ?a^8, a list of tickets grouped
    by msg_type, exact equality of the count, the (lane, ticket) pairs
    and the per-ticket counts: TGS tickets of every DER length form
    (short, 0x81, 0x82, 0x83) and AS-REP tickets with the 0x79 tag and
    with the relaxed 0x7A in one list (two groups), hits at lane 0, at
    the last valid lane of a partial batch, at random lanes, one just
    past the valid lanes and a ticket no candidate opens; the
    Kerberoast's group of 100 TGS tickets at 2^20 lanes (plants at
    ticket positions 0 and past 90); the longest mask (27 positions);
    hit capacity 0, and a worker with hit capacity 0 that recovers its
    hit by the oracle rescan;
25. the KDF kernel against its plain version at the main path's batch
    (2^19 lanes of ?l^8, the last three invalid) and 16 iterations,
    every output word equal, at 4 and 8 words and salts of 1, 19 and 51
    bytes; then three lanes of a 2^20 launch at 4096 iterations against
    hashlib.pbkdf2_hmac;
26. the slice end to end through ``crack --device cuda``: a Kerberoast
    (krb5tgs, 100 tickets of 1,000-1,500 bytes made by the port's
    oracle, 4 planted, one at the window's last index) and an AS-REP
    roast (krb5asrep, 10 hashes, 1 planted) over 2^28 windows of ?a^8,
    the maybes held to what 2^-32 (2^-30) x candidates x tickets
    predicts; krb5tgs-aes etype 18 (4 tickets, 1 planted at the
    window's last index) over 2^22 and krb5asrep17 over 2^20 of ?l^8 at
    4096 iterations; each path with every launch count set to 0 just
    before it and read just after: its own kernel launched once per
    ticket group (etype 23, up to 128 tickets of one msg_type) or ticket
    (AES) and batch, no other; then a krb5pa line under 64 bytes, which
    must exit 2 naming its line and --device cpu;
27. times both kernels with CUDA events beside their bounds
    (ops/opcount.krb5_bound, kdf_ops) and their plain versions (krb5 at
    the Kerberoast's 100 tickets, its plain version and the kernel at
    one ticket; the KDF's on phase 25's input, with the kernel's time
    there beside it), then one
    etype-18 step of the main path and its torch verdict alone;
28. builds csrc/sevenzip.cu and csrc/pdf.cu with the others (csrc/krb5.cu
    and csrc/pdf.cu take their RC4 from csrc/rc4.cuh, and every sha256
    instantiation its rounds from the macro that sha256_compress shares:
    the build phase fails if any pinned instantiation moved);
    holds the 7-Zip KDF kernel against its plain version
    at the main path's batch (whole resident waves, the last three lanes
    invalid), every output word equal, at cycles 8 and 10, salts of 0, 4
    and 16 bytes and masks of 3 and 8 positions, and at cycles 19 against
    hashlib on 64 lanes, the CLI run's planted lanes among them;
29. the PDF kernel against its plain version over 2^16 lanes of ?a^6 for
    R2/40, R3/40, R3/128 and R4/128 with metadata in the clear, the count
    and the sorted lanes equal, the planted lane among them;
30. the slice end to end through ``crack --device cuda``: two stored 7z
    entries at cycles 19 (no salt and a 100-byte payload; a 16-byte salt
    and a 1,024-byte payload, the card's cap) over a 2^18 window of ?l^8,
    and a hashlist of four PDF documents (R2/40, R3/128, R4/128 without
    metadata encryption, R3/40) over a 2^28 window of ?a^6, each with
    every launch count set to 0 just before it and read just after: its
    own kernel (instantiations) launched once per document and batch, no
    other; every plant found, ``rejected=0``;
31. times both kernels with CUDA events beside their bounds
    (ops/opcount.sevenzip_bound, pdf_bound) and their plain versions,
    then one 7z step of the main path and its torch verdict alone;
32. slice G, the window offset and the blocked probe of csrc/mask.cu
    (built in phase 2): the probe instantiation of each core against
    its plain version at config 2's shape (?a^7, 1,000 targets, a batch
    of 2^24 at a window offset), hits at the window's first lane, its
    last valid lane and a lane on the last pass of the grid-stride loop,
    count, lanes, table positions and n_maybe equal; md5 at 8,192
    targets (a 64 KB bitmap, past the 48 KB default); one target and
    the Bloom sets at an offset; configs 1 and 2 of phases 4-5 ran the
    loop superstep (their windows and wall clock beside PR 8's); then
    the single-device worker on configs 1 and 2 with its loop windows
    and with one launch a batch, in the order loop, batch, batch, loop,
    the same found set each time;
33. the sharded path: ``make_sharded_mask_worker`` over a mesh of the
    one card and over 4 shards of it, config 2's shape (ntlm over 2^32
    of ?a^7) at 1,000 and 8,192 targets, md5 with one target over the
    whole ?l^6, and every other core at 1,000 targets over 2^28, each
    with every launch count set to 0 just before it and read just
    after: only its instantiation, once per shard and batch; the found
    set equals the single-device worker's and the plants;
34. times each core's probe instantiation against its Bloom-sets one at
    2^24 a launch, 1,000 and 8,192 targets, beside the bound
    (ops/opcount.probe_ops, ops_per_candidate), the plain version, the
    parent time and the SM clock sampled over the phase;
35. slice L, cores the reference runs on XLA only (built in phase 2):
    sha224 (csrc/mask.cu, one target, the Bloom sets, the probe) and
    mysql323 (one target; its lists run the probe: 2 digest words have
    no Bloom sets) against their plain versions at 2^24 (?a^7 and ?l^6,
    1,000 targets a list; first lane, last valid lane, no hit, a window
    offset), mysql323 over a mask with spaces and tabs (a plant's other
    arrangements collide, counted alike); the salted kernel's wide
    sha512-ps / sha512-sp variants and MSSQL's UTF-16LE placements
    (csrc/salted.cuh; mssql2000 on uppercase-mapped charset tables) at
    the path's group of 256 targets (salts of 0..32 bytes, plants at
    target positions 0 and past 200, lanes 0 and the last valid one):
    each launch of 2^24 against the hashlib plants, and against the
    plain version at ``L_CHECK_LANES``;
36. the slice through ``crack --device cuda``: sha224 (one target over
    ?l^6, 1,000 over 2^32 of ?a^7), ldap-sha and ldap-md5 (1,000 lines
    over ?l^6; ldap-sha over a 2^16-word list with best64), mysql323
    (one target and 1,000 over ?l^6), sha512-ps (a group of 256 over
    ?l^5), sha512-sp (one over ?l^5), mssql2005 and mssql2000 (256
    logins over ?l^6), mssql2012 (256 over ?l^5), each with every launch
    count set to 0 just before it and read just after: only its
    instantiation, once per (group and) batch; and sha224 on the sharded
    runtime (the probe) over 1 and 4 shards of the card;
37. times each new instantiation with CUDA events beside its bound
    (ops/opcount.ops_per_candidate, probe_ops, mysql323_ops,
    salted_ops), its plain version and the SM clock sampled over the
    phase;
38. slice M, target lists of any length (csrc/mask.cu's bulk probe,
    mode 3, ``<core>_mask_bulk`` for all eight cores; the rules kernel's
    lists, ``<core>_rules_probe`` and ``<core>_rules_bulk``; their pins
    in ``CENSUS_M``): every bulk instantiation against its plain version
    at 2^24 and 10^5 targets (planted at the list's first, last and
    random positions; lanes at a window offset, the last valid lane,
    one past it), ntlm in the host-verify layout (max_bytes 256 KiB);
    every list instantiation of the rules kernel at 2^18 words x best64
    (1,000 targets for the probe, 10^5 for the bulk, md5's host-verify
    layout), count, (lane, table position) pairs and n_maybe equal;
39. md5_mask_bulk and ntlm_mask_bulk alone at 10^4, 10^5, 10^6 and 10^7
    random targets (plants at the first, last and a random list
    position found): ms a launch of 2^24 and the flat ratio; the Bloom
    sets, the shared-memory probe and the bulk probe at 1,024, 2,048,
    4,096 and 8,192 targets (``cuda_mask.N_BULK``'s crossover);
40. the host-verify layout through ``crack --device cuda`` (ntlm, 10^5
    targets, the byte budget forced to 512 KiB, a 2^28 window of
    ?a^7): every survivor confirmed by the oracle, ``rejected=0``;
41. config 2 at bulk size: ``crack --engine ntlm ?a^7 --targets-file``
    of 10^6 lines over 2^32 (8 planted), its set-up (parse, table and
    bitmap) and loop times; every other bulk instantiation through the
    CLI at 10^5 targets (2^28 of ?a^7; mysql323 the whole ?l^6);
42. config 3 against lists: sha256 x best64 over the 2^20 words at 1,000
    and 10^5 targets, ntlm at 10^6; md5 and sha1 at 1,000 and 10^5 and
    ntlm at 1,000 over 2^16 words; each path with every launch count
    set to 0 just before it and read just after: only its
    instantiation, once per word window;
43. dense hits: 200 plants in one loop window of md5 ?l^6 at 10^5
    targets and ``--hit-cap 8``: the window is relaunched on the card
    with a buffer of its count, never rescanned by the oracle;
44. times each new instantiation at its main path's list beside its
    bound (``opcount.bulk_ops`` / ``rules_list_ops`` and
    ``bulk_bytes``), its plain version and the SM clock;
45. slice N, wordlist+rules for the salted, nested, Kerberos etype-23,
    sha224 and mysql323 engines (csrc/rules.cu's two new cores,
    csrc/rules_nested.cu's seven chains, csrc/rules_group.cu's tails;
    their pins in ``CENSUS_N``): each new core against its plain version
    at 2^24 candidates (RULE_BATCH words x best64) with one target
    (planted at the window's first word under rule 0 and at its last
    valid word under the last rule), 1,000 targets (the shared-memory
    probe) and N_BULK_TARGETS (the bulk probe); each group tail at its
    main path's group (md5-ps 256 salts of 0-32 bytes, MSSQL 256 logins,
    the Kerberoast's 100 tickets, the others one target; md5-ps and MSSQL
    2000's uppercase at one target) against the plants at 2^24, and
    against its plain version on the same launch of 2^24 candidates, a
    larger group's first N_CHECK_TARGETS targets (count, (lane, target)
    pairs, per-target counts equal);
46. the slice through ``crack --device cuda -a wordlist --rules best64``:
    md5-ps x 1,000 salts, mssql2005 x 256 logins, md5(md5) x 1,000
    targets, the Kerberoast (krb5tgs x 100 tickets), sha224 and mysql323
    over config 3's 2^20 words; every other new instantiation over 2^16
    words (one target, 1,000, N_BULK_TARGETS; one target of each salted
    variant, mssql2000, an AS-REP roast; md5-ps x 4 salts at ``--hit-cap
    1`` with a plant several rules keep as it is, whose window is
    relaunched on the card, ``relaunches=1 rescans=0``); each with every
    launch count set to 0 just before it and read just after: only its
    instantiation, once per (group and) word window and relaunch;
    ``rejected=0``, every plant found;
47. times each new instantiation with CUDA events at its path's launch
    beside its bound (``opcount.rules_ops``, ``rules_list_ops``,
    ``rules_salted_ops`` with each target's own salt, ``rules_krb5_bound``)
    and its plain version (a larger
    group's over N_CHECK_TARGETS targets, beside the kernel's time
    there), and the four K3 rule kernels
    beside ``PERF.md``'s row 4 (``PERF_ROW4_MS``);
48. slice O, wordlist+rules for the wide cores (csrc/rules_wide.cu:
    sha512 and sha384 over SHA-512's 128-byte block, the Keccak sponge at
    rates 144, 136, 104 and 72 with the pad byte a launch parameter, one
    target or a list; sha512's salted tails; their pins in
    ``CENSUS_O``): each new core against its plain version at 2^24
    candidates (RULE_BATCH words x best64) at its path's max_len with one
    target (planted at the last valid word of a partial window under the
    last rule), over words of up to its widest (111 or rate - 1 bytes: a
    word of that length kept as it is planted, through the sha3 name for
    the sponge, so the pad byte and 0x80 share one byte), 1,000 targets
    (the shared-memory probe) and N_BULK_TARGETS (the bulk probe); each
    sha512 tail at its main path's group (sha512-ps 256 salts of 0-32
    bytes, MSSQL 2012 256 logins, sha512-sp one target) against the
    plants at 2^24 and against its plain version on the same launch (a
    larger group's first N_CHECK_TARGETS targets), and sha512-ps over
    words of up to 79 bytes beside salts of up to 32;
49. the slice through ``crack --device cuda -a wordlist --rules best64``:
    sha512 with one target and 1,000, sha3-256 and keccak-224 with one,
    over config 3's 2^20 words; every other new instantiation over 2^16
    words (the sponge's one-target paths through the sha3 names, its
    lists through the keccak names); sha512-ps x slice D's 1,000 salts,
    mssql2012 x 256 logins, sha512-sp x 1; plants at the job's first,
    last and random indices; each with every launch count set to 0 just
    before it and read just after: only its instantiation, once per
    (group and) word window; ``rejected=0``, every plant found;
50. times each new instantiation with CUDA events at its path's launch
    beside its bound (``opcount.rules_ops``, ``rules_list_ops``,
    ``rules_salted_ops`` with each target's own salt, counted by a pool
    of processes while phase 49 runs), its plain version (timed in phase
    48), its registers, shared memory and resident blocks an SM;
51. prints the kernels line (a kernel timed with the SM clock sampled
    also carries the clock, ``sm_mhz``, and its bound at that clock)
    and, last, the device line.

Phases 1-34 print their own seconds (``phase``), and phase 35 all of
them as one JSON object.

Any failure exits non-zero before the last line.  Without a card it
exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

BATCH = 1 << 24
MASK_CONFIG1 = "?l?l?l?l?l?l"
MASK_CONFIG2 = "?a?a?a?a?a?a?a"
MASK_BENCH = "?a?a?a?a?a?a?a?a"
SEED = 20261016
#: targets of the multi-target lists (config 2's size)
N_TARGETS = 1000
#: config 2's window: 256 batches of 2^24
CONFIG2_WINDOW = 1 << 32
#: the other instantiations' windows: 16 batches
OTHER_WINDOW = 1 << 28
#: launches between the CUDA events of one kernel timing
TIMED_LAUNCHES = 50
#: lanes per SM of one pipe on Hopper, INT32 or IMAD (the unit of
#: ops/opcount.Work.slots)
LANES_PER_SM = 64
#: every instantiation: (engine, multi target)
INSTANCES = [(e, m) for e in ("md5", "ntlm", "sha1", "sha256")
             for m in (False, True)]
#: slice G: the cores of the probe instantiations (compare mode 2)
PROBE_CORES = ("md5", "ntlm", "sha1", "sha256", "sha512", "sha384")
PROBE = 2
#: the target counts of the probe's checks and timing
PROBE_TARGETS = (N_TARGETS, 8192)
#: config 1's and config 2's CLI wall clock in PR 8's chip run (PERF.md
#: section 5), one launch a batch; this run's loop superstep beside them
PR8_WALL = {"md5_mask": 0.027, "ntlm_mask_multi": 0.121}
#: the shards of the sharded path's second mesh, all on the one card
SHARDS = 4
#: the C++ core of each engine, as in the kernels' mangled names
CPP_CORE = {"Md5Core": "md5", "Md4Core": "ntlm", "Sha1Core": "sha1",
            "Sha256Core": "sha256", "Sha512Core": "sha512",
            "Sha384Core": "sha384", "Sha224Core": "sha224",
            "Mysql323Core": "mysql323"}
#: the rule kernel's cores, and config 3's list: the reference bench's
#: 2^20 synthetic 8-letter words x best64 (its 64 rules)
RULE_CORES = ("md5", "ntlm", "sha1", "sha256")
CONFIG3_WORDS = 1 << 20
#: the list of the other rule cores' CLI runs
OTHER_WORDS = 1 << 16
N_RULES = 64
#: words per rule-kernel launch: 2^24 candidates under 64 rules
RULE_BATCH = BATCH // N_RULES
#: best64's rules the checks plant under: the 8-op "+0" x 8, a four-op
#: rule, "'7" and "]" (one candidate twice), "p2 '7 p1 x58" (grows an
#: 8-byte word to 24 bytes on the way)
RULE_8OPS, RULE_4OPS, RULE_TRUNC7, RULE_DEL_LAST, RULE_GROW24 = \
    56, 63, 46, 52, 62
#: the card's memory rate, bytes/s (H100 SXM data sheet): the rule
#: kernel's bytes floor
HBM_BYTES_PER_S = 3.35e12
#: config 5: the reference bench's PMKID job (dprf_tpu/bench.py:921-923)
MASK_CONFIG5 = "?l?l?l?l?l?l?l?l"
ESSID5 = b"benchnet"
AP5, STA5 = bytes.fromhex("0a1b2c3d4e5f"), bytes.fromhex("a0b1c2d3e4f5")
#: config 5's window, 32 launches (a depth cut only: at the kernel's ~2 M
#: candidates/s on an H100, 26^8 candidates take a day)
CONFIG5_WINDOW = 1 << 24
#: the PMKID kernel against its plain version: iterations, lanes
PMKID_CHECK_ITERS = 16
PMKID_CHECK_BATCH = 1 << 16
#: config 4: the reference bench's bcrypt job (dprf_tpu/bench.py:926-934)
CONFIG4_WORDS = 1 << 12
CONFIG4_COST = 12
SALT4 = bytes(range(16))
#: the OpenBSD $2a$05 vectors (tests/test_bcrypt_device.py)
OPENBSD = [(b"U*U",
            "$2a$05$CCCCCCCCCCCCCCCCCCCCC.E5YPO9kmyuRGyh0XouQYb4YMJKvyOeW"),
           (b"U*U*U",
            "$2a$05$XXXXXXXXXXXXXXXXXXXXXOAcXxm9kjPGEMsLznoKqmqw7tc8WCx4a")]


#: slice D (ops/cuda_ext.py): every instantiation of csrc/ext.cu,
#: (chain, multi target), in the kernels line's order: the nested chains
#: of the mask kernel template, then the salted kernel's cores (a group
#: of targets a launch, csrc/salted.cuh; multi True)
EXT_INSTANCES = [(n, m) for n in ("md5(md5)", "sha1(sha1)", "md5(sha1)",
                                  "sha1(md5)", "sha256(md5)", "sha256(sha1)",
                                  "mysql41") for m in (False, True)] + \
    [(f"{a}-{o}", True) for a in ("md5", "sha1", "sha256")
     for o in ("ps", "sp")]
#: the salted sweep: md5-ps over ?l^6 against this many targets, each
#: with its own salt of 2-32 bytes
N_SALTED = 1000
#: the salt length of the salted cores' timing launches.  The kernels
#: line times each core at the group its main path launches (md5-ps:
#: phase 18's largest group; the others: one target, phase 18's single
#: target jobs); the per-hash table adds one target and a whole group
TIMING_SALT = 11
#: salt characters of the salted lists (Joomla's and osCommerce's
#: salts are alphanumeric)
ALNUM = b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
#: the nvcc registers and SASS instruction count of the rule
#: instantiations since slice K3 redesigned them (sm_90a, CUDA 12.8): the
#: candidate as 32-bit words in shared-memory slots, runs of rules a
#: thread, a short-message path.  They share csrc/cores.cuh with the mask
#: kernel and must not change when it does (before slice K3: md5 32 /
#: 3,104, ntlm 32 / 2,824, sha1 32 / 3,400, sha256 40 / 4,232)
CENSUS_K3 = {
    "md5_rules": (32, 4512), "ntlm_rules": (32, 4160),
    "sha1_rules": (32, 5152), "sha256_rules": (40, 6776)}
#: the words and rule lines of the every-opcode check (phase 8): the
#: reference's rule-kernel test set (tests/test_torch_rules.py) less the
#: ops the kernel refuses (@, E, e)
RULE_WORDS = ([b"alpha", b"bravo", b"s3cret", b"Delta", b"echo99",
               b"FOXtrot", b"g0lf!", b"hotellll", b"in", b"j", b"",
               b"aAzZ09!~", b"xxxxxxxxxxxxxxxx"]
              + [b"w%02d" % i for i in range(19)])
#: the max_len of the every-opcode check, by core: the shortest and the
#: longest a core takes (it ran at 27 too, until slice O cut phase 8 in
#: depth: 66.8 s, the deepest phase)
RULES_ALL_OPS_MAX_LEN = {"ntlm": (16, 27)}
RULES_ALL_OPS = [
    ":", "l", "u", "c", "C", "t", "T2", "r", "d", "p2", "f", "{", "}", "[",
    "]", "D2", "x12", "O12", "i2X", "o2Y", "'3", "se3", "z2", "Z2", "q", "k",
    "K", "*03", "L2", "R2", "+2", "-2", ".2", ",2", "y2", "Y2", "$!", "^#",
    "<5", ">3", "_6", "!x", "/e", "(a", ")o", "=1e", "%2e", "c $1 $2 $3",
    "u r ]", "TZ", "oZa", "=Za", "x0Z", "*0Z", "p9"]
#: the nvcc registers and SASS instruction count of every instantiation
#: of the mask kernel template (csrc/mask.cu, ext.cu, keccak.cu) and of
#: the bcrypt kernels since slice K2 (sm_90a, CUDA 12.8).  The earlier
#: mask, ext and keccak pins (the kernel body's first, and those the
#: window offset moved) moved again because the
#: kernel body changed for every core: a 64-byte core's thread now takes
#: runs of lanes (the reciprocal decode once a run, the last position
#: stepped a lane, three arrays more among the kernel parameters), and a
#: wide core's parameters lost the unused byte shift; bcrypt's block
#: became four warps of 16, 16, 16 and 8 candidates with a shorter round
CENSUS_K2 = {
    "md5_mask": (40, 2024), "md5_mask_multi": (45, 1688),
    "md5_mask_probe": (40, 1808), "ntlm_mask": (42, 1312),
    "ntlm_mask_multi": (42, 1064), "ntlm_mask_probe": (40, 1128),
    "sha1_mask": (48, 2312), "sha1_mask_multi": (48, 1984),
    "sha1_mask_probe": (48, 2112), "sha256_mask": (53, 3144),
    "sha256_mask_multi": (53, 2752), "sha256_mask_probe": (54, 2928),
    "sha512_mask": (58, 8464), "sha512_mask_multi": (64, 7672),
    "sha512_mask_probe": (64, 7680), "sha384_mask": (58, 8456),
    "sha384_mask_multi": (64, 7664), "sha384_mask_probe": (64, 7672),
    "md5(md5)_mask": (54, 2440), "md5(md5)_mask_multi": (57, 2048),
    "sha1(sha1)_mask": (48, 3136), "sha1(sha1)_mask_multi": (48, 2808),
    "md5(sha1)_mask": (48, 2840), "md5(sha1)_mask_multi": (48, 2504),
    "sha1(md5)_mask": (48, 2792), "sha1(md5)_mask_multi": (48, 2456),
    "sha256(md5)_mask": (53, 3576), "sha256(md5)_mask_multi": (53, 3184),
    "sha256(sha1)_mask": (54, 3936), "sha256(sha1)_mask_multi": (53, 3544),
    "mysql41_mask": (48, 2888), "mysql41_mask_multi": (48, 2560),
    "keccak224_mask": (70, 11488), "keccak224_mask_multi": (71, 9688),
    "keccak256_mask": (71, 10888), "keccak256_mask_multi": (71, 9408),
    "keccak384_mask": (71, 8992), "keccak384_mask_multi": (72, 8416),
    "keccak512_mask": (71, 7440), "keccak512_mask_multi": (72, 7280),
    "bcrypt_setup": (48, 8856), "bcrypt_advance": (64, 17144),
    "bcrypt_finish": (40, 3008)}
#: slice K2: each redesigned kernel's parent time per launch, ms, from
#: PERF.md's table before slice K2 (an NVIDIA H100 80GB HBM3 at 700 W): the
#: mask, ext and keccak instantiations at 2^24 lanes (?l^6 for md5 with
#: one target, else ?a^7; 1,000 targets a list), the bcrypt kernels at
#: the parent's wave of 4,224 candidates (advance: 16 cost rounds)
PARENT_MS = {
    "md5_mask": 0.4192, "md5_mask_multi": 0.4674, "ntlm_mask": 0.3375,
    "ntlm_mask_multi": 0.3622, "sha1_mask": 0.7097,
    "sha1_mask_multi": 0.7327, "sha256_mask": 1.4363,
    "sha256_mask_multi": 1.4878, "sha512_mask": 3.8759,
    "sha512_mask_multi": 3.9241, "sha384_mask": 3.8347,
    "sha384_mask_multi": 3.9029, "md5_mask_probe": 0.4499,
    "ntlm_mask_probe": 0.3569, "sha1_mask_probe": 0.7319,
    "sha256_mask_probe": 1.4806, "sha512_mask_probe": 3.8740,
    "sha384_mask_probe": 3.8597, "md5(md5)_mask": 0.7717,
    "md5(md5)_mask_multi": 0.7980, "sha1(sha1)_mask": 1.3383,
    "sha1(sha1)_mask_multi": 1.3895, "md5(sha1)_mask": 1.0713,
    "md5(sha1)_mask_multi": 1.1009, "sha1(md5)_mask": 1.0187,
    "sha1(md5)_mask_multi": 1.0275, "sha256(md5)_mask": 1.7420,
    "sha256(md5)_mask_multi": 1.7934, "sha256(sha1)_mask": 2.1115,
    "sha256(sha1)_mask_multi": 2.1640, "mysql41_mask": 1.1694,
    "mysql41_mask_multi": 1.2182, "keccak224_mask": 5.2844,
    "keccak224_mask_multi": 5.4017, "keccak256_mask": 5.2938,
    "keccak256_mask_multi": 5.3687, "keccak384_mask": 5.3426,
    "keccak384_mask_multi": 5.3811, "keccak512_mask": 5.3228,
    "keccak512_mask_multi": 5.3541, "bcrypt_setup": 0.425,
    "bcrypt_advance": 8.723, "bcrypt_finish": 0.192}
#: the parent's bcrypt wave (132 SMs x 32 candidates), where slice K2's
#: advance is also timed
PARENT_BCRYPT_WAVE = 4224
#: Feistel rounds of one cost round of one candidate (2 ExpandKeys x 521
#: encryptions x 16 rounds)
FEISTEL_PER_COST_ROUND = 2 * 521 * 16
#: slice F2: the Kerberoast's and the AS-REP roast's windows of ?a^8, and
#: their ticket counts
KRB5_WINDOW = 1 << 28
KERBEROAST_TICKETS, ASREP_TICKETS = 100, 10
#: the lanes of the krb5 check at the Kerberoast's group of tickets: the
#: plain version runs RC4 in torch a ticket at a time (~1.8 s a ticket
#: at 2^24 lanes, phase 27), so 100 tickets are held at 2^20
KRB5_GROUP_LANES = 1 << 20
#: the AES runs' windows of ?l^8 (etype 18, 4 tickets; etype 17, one)
AES18_WINDOW, AES17_WINDOW = 1 << 22, 1 << 20
#: the KDF kernel against its plain version: iterations; then
#: the deployed count against hashlib over KDF_HASHLIB_LANES
KDF_CHECK_ITERS = 16
KDF_ITERS, KDF_HASHLIB_LANES = 4096, 1 << 20
#: the realm || principal salt of the KDF's timing launches
KDF_TIMING_SALT = b"CORP.LOCALsvc_sql01"
#: the nvcc registers and SASS instruction count of pmkid before the KDF
#: kernel joined csrc/pbkdf2.cu (sm_90a, CUDA 12.8), which must not
#: change them
PMKID_BEFORE = (59, 10656)
#: the nvcc registers and SASS instruction count of the grouped kernels
#: (sm_90a, CUDA 12.8): the salted kernel's six cores (csrc/salted.cuh)
#: and krb5 (csrc/krb5.cu).  They replaced the six salted instantiations
#: of the mask kernel template and the per-ticket krb5 kernel (32
#: registers, 6,336 instructions), redesigned to serve a group of targets
#: a launch
CENSUS_GROUPED = {
    "md5-ps_group": (47, 2120), "md5-sp_group": (47, 2264),
    "sha1-ps_group": (46, 2128), "sha1-sp_group": (46, 2264),
    "sha256-ps_group": (48, 2952), "sha256-sp_group": (48, 3088),
    "krb5_group": (32, 6112)}
#: the nvcc registers and SASS instruction count of the pdf instantiations
#: (sm_90a, CUDA 12.8), which share csrc/rc4.cuh with krb5 and must not
#: change when krb5 does
PDF_BEFORE = {"pdf_r2_40": (32, 5560), "pdf_r3_128": (79, 6152),
              "pdf_r3_40": (63, 6096)}
#: slice F3: the 7-Zip KDF's cycles power (7-Zip's default) and the mask
#: and window of its CLI run
SEVENZIP_CYCLES = 19
SEVENZIP_WINDOW = 1 << 18
#: the KDF against its plain version: (mask length, salt bytes, cycles);
#: units of 14 (7-block groups), 28, 30, 40 (the CLI's salted entry's,
#: 5-block groups) and 24 bytes (the main path's unsalted unit, whose
#: plain time the kernels line carries)
SEVENZIP_CHECKS = [(3, 0, 8), (8, 4, 8), (3, 16, 8), (8, 16, 8),
                   (8, 0, 10)]
#: lanes of the cycles-19 launch held against hashlib
SEVENZIP_HASHLIB_LANES = 64
#: the PDF documents: (revision, key bits, metadata encrypted) and the
#: CLI's window of ?a^6.  The kernel against its plain version: R2 at the
#: main path's batch (BATCH); the R3 kinds, whose plain version would take
#: minutes at BATCH, at PDF_R3_CHECK_BATCH, five resident waves, so that
#: every thread takes later passes of the grid-stride loop.  The plain
#: version runs in pieces of PDF_PLAIN_CHUNK lanes (its RC4 states take
#: 1 KiB a lane)
PDF_DOCS = [(2, 40, True), (3, 128, True), (4, 128, False), (3, 40, True)]
PDF_R3_CHECK_BATCH = 1 << 19
PDF_PLAIN_CHUNK = 1 << 22
PDF_WINDOW = 1 << 28
MASK_PDF = "?a?a?a?a?a?a"
#: slice F1: the 64-bit cores' instantiations, (kernel name, engine the
#: checks drive it through, multi target), in the kernels line's order;
#: sha3-N and keccak-N share keccakN's instantiation
F1_INSTANCES = [(f"{e}_mask" + ("_multi" if m else ""), e, m)
                for e in ("sha512", "sha384") for m in (False, True)] + \
    [(f"keccak{b}_mask" + ("_multi" if m else ""), f"sha3-{b}", m)
     for b in (224, 256, 384, 512) for m in (False, True)]
#: the Keccak rates by digest bits; the longest mask of each core
KECCAK_RATE = {224: 144, 256: 136, 384: 104, 512: 72}
#: slice L: the new instantiations of the mask kernel template, (kernel
#: name, engine, compare mode), and of the salted kernel, (variant, the
#: engine its main path and timing drive it through), in the kernels
#: line's order; the reference has no Pallas kernel for any of them
L_MASK = [("sha224_mask", "sha224", 0), ("sha224_mask_multi", "sha224", 1),
          ("sha224_mask_probe", "sha224", 2), ("mysql323_mask", "mysql323", 0),
          ("mysql323_mask_probe", "mysql323", 2)]
L_SALTED = [("sha512-ps", "sha512-ps"), ("sha512-sp", "sha512-sp"),
            ("sha1-ps-utf16", "mssql2005"), ("sha512-ps-utf16", "mssql2012")]
L_KERNELS = [k for k, _, _ in L_MASK] + [f"{v}_group" for v, _ in L_SALTED]
#: the lanes of a salted variant's check against its plain version at a
#: group of 256: the plain version runs the core in torch a target at a
#: time (sha512's took 8.8-15.4 s for 256 targets at 2^19 lanes), so the
#: wide ones are held at 2^18 lanes and sha1's at 2^20, several resident
#: waves; each launch at 2^24 is held to the hashlib plants alone
L_CHECK_LANES = {"sha512-ps": 1 << 18, "sha512-sp": 1 << 18,
                 "sha1-ps-utf16": 1 << 20, "sha512-ps-utf16": 1 << 18}
#: the nvcc registers and SASS instruction count of slice L's
#: instantiations (sm_90a, CUDA 12.8), pinned from their first build;
#: none has a stack frame.  sha224's are sha256's but for its probe (8
#: fewer); the wide salted variants hold 97 registers
CENSUS_L = {
    "sha224_mask": (53, 3144), "sha224_mask_multi": (53, 2752),
    "sha224_mask_probe": (54, 2920), "mysql323_mask": (32, 2704),
    "mysql323_mask_probe": (32, 2496), "sha512-ps_group": (97, 8160),
    "sha512-sp_group": (97, 8424), "sha1-ps-utf16_group": (46, 1488),
    "sha512-ps-utf16_group": (97, 6040)}


#: slice M, target lists of any length: the bulk probe's cores (every
#: core of csrc/mask.cu), the lists of its checks against the plain
#: version and of the other cores' CLI paths, config 2 at bulk size
#: (10^6 NTLM lines), the kernel alone from 10^4 to 10^7 targets, the
#: list lengths of the sets / probe / bulk crossover, the plants of the
#: dense-hit window, and the rules kernel's CLI paths (engine, words,
#: targets, compare mode 2 the shared-memory probe or 3 the bulk probe)
M_MASK_CORES = ("md5", "ntlm", "sha1", "sha256", "sha512", "sha384",
                "sha224", "mysql323")
M_DIGEST_BYTES = {"md5": 16, "ntlm": 16, "sha1": 20, "sha256": 32,
                  "sha512": 64, "sha384": 48, "sha224": 28, "mysql323": 8}
M_CHECK_TARGETS = 10 ** 5
M_CONFIG2_TARGETS = 10 ** 6
M_FLAT_TARGETS = (10 ** 4, 10 ** 5, 10 ** 6, 10 ** 7)
M_CROSS_TARGETS = (1024, 2048, 4096, 8192)
M_DENSE_PLANTS = 200
M_RULE_PATHS = [("sha256", CONFIG3_WORDS, 1000, 2),
                ("sha256", CONFIG3_WORDS, 10 ** 5, 3),
                ("ntlm", CONFIG3_WORDS, 10 ** 6, 3),
                ("md5", OTHER_WORDS, 1000, 2), ("md5", OTHER_WORDS, 10 ** 5, 3),
                ("sha1", OTHER_WORDS, 1000, 2),
                ("sha1", OTHER_WORDS, 10 ** 5, 3),
                ("ntlm", OTHER_WORDS, 1000, 2)]
M_KERNELS = [f"{e}_mask_bulk" for e in M_MASK_CORES] + [
    f"{e}_rules_{m}" for e in ("md5", "ntlm", "sha1", "sha256")
    for m in ("probe", "bulk")]
#: the nvcc registers and SASS instruction count of slice M's
#: instantiations (sm_90a, CUDA 12.8), pinned from their first build;
#: none has a stack frame.  A bulk instantiation is its probe's but for
#: the staging loop (mysql323's holds 6 more registers), a rules list
#: instantiation its one-target one's registers and ~270 more
#: instructions (the whole digest and the probe)
CENSUS_M = {
    "md5_mask_bulk": (40, 1808), "ntlm_mask_bulk": (40, 1112),
    "sha1_mask_bulk": (48, 2112), "sha256_mask_bulk": (54, 2928),
    "sha512_mask_bulk": (59, 7680), "sha384_mask_bulk": (58, 7672),
    "sha224_mask_bulk": (54, 2928), "mysql323_mask_bulk": (38, 2488),
    "md5_rules_probe": (32, 4784), "md5_rules_bulk": (32, 4672),
    "ntlm_rules_probe": (32, 4424), "ntlm_rules_bulk": (32, 4312),
    "sha1_rules_probe": (32, 5416), "sha1_rules_bulk": (32, 5304),
    "sha256_rules_probe": (40, 7056), "sha256_rules_bulk": (40, 6944)}

#: slice N, wordlist+rules of the salted, nested and Kerberos engines and
#: of sha224 and mysql323: the rules kernel's new cores (csrc/rules.cu's
#: sha224 and mysql323, csrc/rules_nested.cu's chains) and its group
#: tails (csrc/rules_group.cu: the salted variants, Kerberos etype 23)
N_CORES = ("sha224", "mysql323", "md5(md5)", "sha1(sha1)", "md5(sha1)",
           "sha1(md5)", "sha256(md5)", "sha256(sha1)", "mysql41")
N_TAILS = ("md5-ps", "md5-sp", "sha1-ps", "sha1-sp", "sha256-ps",
           "sha256-sp", "sha1-ps-utf16", "krb5")
N_KERNELS = [f"{e}_rules{m}" for e in N_CORES
             for m in ("", "_probe", "_bulk")] + [f"{t}_rules" for t in N_TAILS]
#: a bulk list of the rules kernel (past cuda_mask.N_BULK)
N_BULK_TARGETS = 4096
#: targets of a group tail's check against its plain version at the
#: main path's launch: a larger group's first ones, its plants included
N_CHECK_TARGETS = 8
#: the shortest planted candidate of slice N's paths
N_PLANT_LEN = 6
#: the group tails' checks and timing: (tail, max_len, targets, salt
#: length or None for salts of 0-32 bytes, MSSQL 2000's uppercase) -- the
#: groups of the main paths of phase 46: md5-ps's first group of its
#: 1,000 salts, mssql2005's 256 logins, the Kerberoast's 100 tickets, the
#: other variants' one target; and md5-ps and MSSQL 2000 at one target.
#: A tail's first case is its row of the kernels line.
N_GROUP_CASES = [
    ("md5-ps", 23, 256, None, False), ("md5-ps", 23, 1, None, False),
    ("md5-sp", 23, 1, 11, False),
    ("sha1-ps", 23, 1, None, False), ("sha1-sp", 23, 1, 11, False),
    ("sha256-ps", 23, 1, None, False), ("sha256-sp", 23, 1, 11, False),
    ("sha1-ps-utf16", 25, 256, 4, False), ("sha1-ps-utf16", 25, 1, 4, True),
    ("krb5", 27, KERBEROAST_TICKETS, None, False)]
#: the core paths over config 3's whole list (the others over OTHER_WORDS):
#: (engine, compare mode)
N_FULL_CORES = {("sha224", 0), ("mysql323", 0), ("md5(md5)", 2)}
#: the salted paths: (engine, tail, targets, words, salt length or None
#: for slice D's 2-32 bytes)
N_SALTED_PATHS = [
    ("md5-ps", "md5-ps", N_SALTED, CONFIG3_WORDS, None),
    ("mssql2005", "sha1-ps-utf16", 256, CONFIG3_WORDS, 4),
    ("mssql2000", "sha1-ps-utf16", 1, OTHER_WORDS, 4),
    ("md5-sp", "md5-sp", 1, OTHER_WORDS, 11),
    ("sha1-ps", "sha1-ps", 1, OTHER_WORDS, None),
    ("sha1-sp", "sha1-sp", 1, OTHER_WORDS, 11),
    ("sha256-ps", "sha256-ps", 1, OTHER_WORDS, None),
    ("sha256-sp", "sha256-sp", 1, OTHER_WORDS, 11)]
#: PERF.md's row 4: the K3 rule instantiations' ms a launch of 2^24, in
#: turns with their parent when slice K3 redesigned them (an NVIDIA H100
#: 80GB HBM3 at 700 W)
PERF_ROW4_MS = {"md5_rules": 0.3362, "ntlm_rules": 0.2740,
                "sha1_rules": 0.6278, "sha256_rules": 1.3530}
#: the nvcc registers and SASS instruction count of slice N's
#: instantiations (sm_90a, CUDA 12.8), pinned from their first build; none
#: has a stack frame.  A nested or sha224 core holds its chain's registers
#: (32, or 40 with a sha256 stage); the salted tails hold 40-58, the
#: Kerberos tail 40 (krb5_group 32)
CENSUS_N = {
    "sha224_rules": (40, 6776), "sha224_rules_probe": (40, 7056),
    "sha224_rules_bulk": (40, 6936), "mysql323_rules": (40, 5648),
    "mysql323_rules_probe": (40, 5880), "mysql323_rules_bulk": (40, 5768),
    "md5(md5)_rules": (32, 5400), "md5(md5)_rules_probe": (32, 5672),
    "md5(md5)_rules_bulk": (32, 5560), "sha1(sha1)_rules": (32, 6792),
    "sha1(sha1)_rules_probe": (32, 7064),
    "sha1(sha1)_rules_bulk": (32, 6944), "md5(sha1)_rules": (32, 6192),
    "md5(sha1)_rules_probe": (32, 6464), "md5(sha1)_rules_bulk": (32, 6352),
    "sha1(md5)_rules": (32, 6064), "sha1(md5)_rules_probe": (32, 6336),
    "sha1(md5)_rules_bulk": (32, 6216), "sha256(md5)_rules": (40, 7656),
    "sha256(md5)_rules_probe": (40, 7920),
    "sha256(md5)_rules_bulk": (40, 7800), "sha256(sha1)_rules": (40, 8392),
    "sha256(sha1)_rules_probe": (40, 8656),
    "sha256(sha1)_rules_bulk": (40, 8544), "mysql41_rules": (32, 6296),
    "mysql41_rules_probe": (32, 6568), "mysql41_rules_bulk": (32, 6448),
    "md5-ps_rules": (48, 4488), "md5-sp_rules": (40, 4576),
    "sha1-ps_rules": (48, 4800), "sha1-sp_rules": (48, 4880),
    "sha256-ps_rules": (58, 5616), "sha256-sp_rules": (58, 5728),
    "sha1-ps-utf16_rules": (40, 4840), "krb5_rules": (40, 9432)}

#: slice O, wordlist+rules for the wide cores (csrc/rules_wide.cu): sha512
#: and sha384 over SHA-512's 128-byte block, the sponge at its four rates
#: (driven through the keccak-N names, pad 0x01; the sha3-N names, pad
#: 0x06, share each instantiation: ``O_SHA3``), one target or a list, and
#: sha512's salted tails
O_CORES = ("sha512", "sha384", "keccak224", "keccak256", "keccak384",
           "keccak512")
O_SHA3 = {"keccak224": "sha3-224", "keccak256": "sha3-256",
          "keccak384": "sha3-384", "keccak512": "sha3-512"}
O_TAILS = ("sha512-ps", "sha512-sp", "sha512-ps-utf16")
O_KERNELS = [f"{e}_rules{m}" for e in O_CORES
             for m in ("", "_probe", "_bulk")] + [f"{t}_rules" for t in O_TAILS]
#: each core's and tail's max_len on its main path: the CPU oracle's limit,
#: which both CLIs take (sha3-256 and keccak-256: 55, not the sponge's 135)
O_MAX_LEN = {"sha512": 111, "sha384": 111, "keccak224": 143,
             "keccak256": 55, "keccak384": 103, "keccak512": 71,
             "sha512-ps": 79, "sha512-sp": 79, "sha512-ps-utf16": 53}
#: the widest rule outputs of a core (its kMaxLen: 111, or rate - 1): the
#: long-word checks run there, over words of O_LONG_SPAN bytes up to it
O_WIDEST = {"sha512": 111, "sha384": 111, "keccak224": 143,
            "keccak256": 135, "keccak384": 103, "keccak512": 71}
O_LONG_SPAN = 44
#: the group tails' checks and timing, as ``N_GROUP_CASES``: (tail, max_len,
#: targets, salt length or None for salts of 0-32 bytes) -- the groups of
#: the main paths of phase 49: sha512-ps's first group of slice D's 1,000
#: salts, mssql2012's 256 logins, sha512-sp's one target
O_GROUP_CASES = [("sha512-ps", 79, 256, None), ("sha512-sp", 79, 1, 11),
                 ("sha512-ps-utf16", 53, 256, 4)]
#: the engine of a sponge core's one-target path (its lists run the
#: keccak-N names: both pad bytes run on a path)
O_ONE_TARGET = {"keccak224": "keccak-224", "keccak256": "sha3-256",
                "keccak384": "sha3-384", "keccak512": "sha3-512"}
#: the core paths over config 3's whole list (the others over
#: OTHER_WORDS): (engine, targets)
O_FULL_PATHS = {("sha512", 1), ("sha512", N_TARGETS), ("sha3-256", 1),
                ("keccak-224", 1)}
#: the nvcc registers and SASS instruction count of slice O's
#: instantiations (sm_90a, CUDA 12.8), pinned from their first build (the
#: sponge's from its build with the pad byte in the slot and three blocks
#: an SM asked for: before, its message block went to local memory, then
#: two of its one-target instantiations spilled at 64 registers); none
#: has a stack frame.  The sha512-sp tail holds 126 registers
CENSUS_O = {
    "sha512_rules": (63, 11152), "sha512_rules_probe": (64, 11392),
    "sha512_rules_bulk": (64, 11280), "sha384_rules": (64, 11128),
    "sha384_rules_probe": (64, 11376), "sha384_rules_bulk": (64, 11264),
    "keccak224_rules": (79, 13088), "keccak224_rules_probe": (78, 13336),
    "keccak224_rules_bulk": (78, 13232), "keccak256_rules": (79, 13072),
    "keccak256_rules_probe": (79, 13328),
    "keccak256_rules_bulk": (79, 13216), "keccak384_rules": (79, 13072),
    "keccak384_rules_probe": (79, 13320),
    "keccak384_rules_bulk": (79, 13200), "keccak512_rules": (79, 13160),
    "keccak512_rules_probe": (80, 13408),
    "keccak512_rules_bulk": (80, 13280),
    "sha512-ps_rules": (97, 8144), "sha512-sp_rules": (126, 8080),
    "sha512-ps-utf16_rules": (97, 8088)}


#: the seconds of each phase that prints no time of its own (1-34), by
#: phase: ``phase`` ends one and starts the next
PHASE_S = {}
_PHASE = {"n": None, "t": 0.0}


def phase(n) -> None:
    """Print the time of the phase that ends here and start phase ``n``
    (None: no phase)."""
    now = time.perf_counter()
    if _PHASE["n"] is not None:
        PHASE_S[_PHASE["n"]] = now - _PHASE["t"]
        say(f"  phase {_PHASE['n']}: {PHASE_S[_PHASE['n']]:.1f} s")
    _PHASE.update(n=n, t=now)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


#: the SM clock under load, sampled while a block of work runs with
#: nvidia-smi's loop mode (``--query-gpu=clocks.sm --loop-ms=PERIOD``) in
#: a process of its own from ``__enter__`` to ``__exit__``, which stops
#: it and waits for it: ``with SmClock() as clock: ...`` (launches, then
#: torch.cuda.synchronize()), then ``clock.mhz``, the median sample or
#: None.  nvidia-smi takes ~0.1-0.3 s to print its first sample, more on
#: a busy host, so ``__enter__`` waits for that sample (at most
#: ``FIRST_S`` seconds) before the block runs, and the block keeps the
#: card busy for half a second or more (``busy``).
class SmClock:
    FIRST_S = 20.0

    def __init__(self, period_ms: int = 20, device: int = 0):
        self.cmd = ["nvidia-smi", f"--id={device}", "--query-gpu=clocks.sm",
                    "--format=csv,noheader,nounits", f"--loop-ms={period_ms}"]
        self.samples: list = []
        self._first = ""
        self._proc = None

    def __enter__(self) -> "SmClock":
        import select
        self._proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL, text=True)
        if select.select([self._proc.stdout], [], [], self.FIRST_S)[0]:
            self._first = self._proc.stdout.readline()
        return self

    def __exit__(self, *exc) -> None:
        self._proc.terminate()
        try:
            out, _ = self._proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            out, _ = self._proc.communicate()
        self.samples = [float(x) for x in (self._first + out).split()
                        if x.replace(".", "", 1).isdigit()]

    @property
    def mhz(self):
        """The median sample in MHz, or None if nvidia-smi printed none."""
        return statistics.median(self.samples) if self.samples else None


def busy(torch, fn, seconds: float = 0.6, chunk: int = 8) -> tuple:
    """Call ``fn`` in chunks of ``chunk`` calls until ``seconds`` of wall
    clock passed, timing the calls with CUDA events (the time between
    chunks, the host's sync, is not counted).  Returns (ms a call,
    calls)."""
    ms, calls = 0.0, 0
    t_end = time.perf_counter() + seconds
    while calls == 0 or time.perf_counter() < t_end:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(chunk):
            fn()
        t1.record()
        torch.cuda.synchronize()
        ms += t0.elapsed_time(t1)
        calls += chunk
    return ms / calls, calls


def kname(engine: str, mode) -> str:
    """A mask instantiation's name: mode False / 0 one target, True / 1
    the Bloom sets, 2 the blocked probe, 3 the bulk probe."""
    return f"{engine}_mask" + ("", "_multi", "_probe", "_bulk")[int(mode)]


def rname(engine: str, mode: int = 0) -> str:
    """A rule instantiation's name: mode 0 one target, 2 a list's
    shared-memory probe, 3 its bulk probe."""
    return f"{engine}_rules" + {0: "", 2: "_probe", 3: "_bulk"}[int(mode)]


def ename(chain: str, multi: bool) -> str:
    """An ext instantiation's name: the nested chain's mask kernel, or a
    salted core's grouped kernel (``cuda_ext.kernel_name``)."""
    return f"{chain}_group" if "-" in chain else kname(chain, multi)


#: the grouped kernels, whose registers and SASS count CENSUS_GROUPED pins
GROUPED_KERNELS = {f"{a}-{o}_group" for a in ("md5", "sha1", "sha256")
                   for o in ("ps", "sp")} | {"krb5_group"}


#: the single-instantiation kernels, by their function name
PLAIN_KERNELS = {"pmkid_kernel": "pmkid", "setup_kernel": "bcrypt_setup",
                 "advance_kernel": "bcrypt_advance",
                 "finish_kernel": "bcrypt_finish", "kdf_kernel": "pbkdf2_kdf",
                 "krb5_kernel": "krb5_group",
                 "sevenzip_kernel": "sevenzip_kdf"}


def instance_of(mangled: str) -> str:
    """The kernel name of a mangled mask_kernel<Core, multi>,
    rules_kernel<Core> or single kernel's symbol."""
    m = re.search(r"pdf_kernelILi(\d)ELi(\d+)E", mangled)
    if m:
        return f"pdf_r{m.group(1)}_{8 * int(m.group(2))}"
    for fn, name in PLAIN_KERNELS.items():
        if re.search(rf"\d{fn}", mangled):
            return name
    m = re.search(r"salted_kernelI\d+(\w+?Core)Lb([01])E(5Utf16)?", mangled)
    if m:
        return f"{CPP_CORE[m.group(1)]}-{'sp' if m.group(2) == '1' else 'ps'}"\
            f"{'-utf16' if m.group(3) else ''}_group"
    m = re.search(r"rules_group_kernelI\d+(\w+?Core)\d+(\w+?)Ev", mangled)
    if m:
        if m.group(2) == "Krb5Tail":
            return "krb5_rules"
        sp, utf16 = re.search(r"Lb([01])ELb([01])E", m.group(2)).groups()
        return f"{CPP_CORE[m.group(1)]}-{'sp' if sp == '1' else 'ps'}" \
            f"{'-utf16' if utf16 == '1' else ''}_rules"
    m = re.search(r"(mask|rules|rules_wide)_kernelI(\w+?)L7Compare([0123])E",
                  mangled)
    if m:
        args, multi = m.group(2), int(m.group(3))
        cores = [CPP_CORE[c] for c in re.findall(
            r"\d+(Md5Core|Md4Core|Sha1Core|Sha256Core|Sha512Core|Sha384Core"
            r"|Sha224Core|Mysql323Core)",
            args)]
        keccak = re.search(r"KeccakCoreILi(\d+)E", args)
        if keccak:
            chain = f"keccak{(200 - int(keccak.group(1))) * 4}"
        elif "Mysql41" in args:
            chain = "mysql41"
        elif "Nested" in args:          # outer, then inner (or S<n>_: same)
            chain = f"{cores[0]}({cores[-1]})"
        else:
            chain = cores[0]
        return (kname if m.group(1) == "mask" else rname)(chain, multi)
    return mangled


def synthetic_words(n: int, length: int = 8) -> list:
    """The reference bench's deterministic word list (its LCG): n words
    of `length` lowercase letters."""
    import numpy as np
    xs = np.empty(n, dtype=np.int64)
    x = 12345
    for i in range(n):
        x = (1103515245 * x + 12345) & 0x7FFFFFFF
        xs[i] = x
    letters = np.stack([(xs >> (3 * j)) % 26 for j in range(length)], 1)
    rows = (letters + ord("a")).astype(np.uint8)
    return [r.tobytes() for r in rows]


def fake_pmkid_line() -> str:
    """The reference bench's PMKID target: a PMKID no passphrase is
    known to give, config 5's ESSID and MACs."""
    pmkid = bytes((5 * i + 1) % 256 for i in range(16))
    return f"{pmkid.hex()}*{AP5.hex()}*{STA5.hex()}*{ESSID5.hex()}"


def fake_bcrypt_line(cost: int) -> str:
    """The reference bench's bcrypt target: a digest no word is known to
    give, salt bytes(range(16))."""
    from dprf_tpu_torch.engines.cpu.bcrypt import b64_encode
    digest = bytes((7 * i + 3) % 256 for i in range(23))
    return (f"$2b${cost:02d}$" + b64_encode(SALT4)[:22]
            + b64_encode(digest)[:31])


def pmkid_line(plain: bytes, essid: bytes, ap: bytes, sta: bytes,
               iterations: int) -> str:
    """A hashcat 16800 line for ``plain``, by hashlib."""
    import hmac
    pmk = hashlib.pbkdf2_hmac("sha1", plain, essid, iterations, 32)
    pmkid = hmac.new(pmk, b"PMK Name" + ap + sta, hashlib.sha1).digest()
    return f"{pmkid[:16].hex()}*{ap.hex()}*{sta.hex()}*{essid.hex()}"


def little_endian(engine: str) -> bool:
    """The byte order of an engine's (final) digest words."""
    from dprf_tpu_torch import get_engine
    return get_engine(engine, "cuda", torch_device="cpu").little_endian


def digest_words(engine: str, digest: bytes) -> list:
    from dprf_tpu_torch.ops.compare import digest_rows
    return [int(w) for w in digest_rows([digest], little_endian(engine))[0]]


class Smoke:
    def __init__(self):
        import numpy as np
        import torch

        from dprf_tpu_torch import get_engine
        from dprf_tpu_torch.ops import bloom, cuda_mask
        from dprf_tpu_torch.ops.compare import make_target_table

        self.np, self.torch = np, torch
        self.get_engine, self.bloom, self.cm = get_engine, bloom, cuda_mask
        self.make_target_table = make_target_table
        self.rng = np.random.default_rng(SEED)
        #: per instantiation: largest |kernel - plain| over its cases
        self.err = {kname(e, m): 0 for e, m in INSTANCES}
        self.err.update({rname(e): 0 for e in RULE_CORES})
        self.err.update({k: 0 for k in ("pmkid", "bcrypt_setup",
                                        "bcrypt_advance", "bcrypt_finish")})
        self.err.update({ename(n, m): 0 for n, m in EXT_INSTANCES})
        self.err.update({k: 0 for k, _, _ in F1_INSTANCES})
        self.err.update({"krb5_group": 0, "pbkdf2_kdf": 0, "sevenzip_kdf": 0,
                         "pdf": 0})
        self.err.update({kname(e, PROBE): 0 for e in PROBE_CORES})
        self.err.update({k: 0 for k in L_KERNELS})
        self.err.update({k: 0 for k in M_KERNELS})
        self.err.update({k: 0 for k in N_KERNELS})
        self.err.update({k: 0 for k in O_KERNELS})
        #: per instantiation: launches of the main path that runs it
        self.path_launches = {}
        #: configs 1 and 2 through the loop superstep: (wall s, windows,
        #: launches) by instantiation
        self.loop_walls = {}

    # -- targets ---------------------------------------------------------

    def fillers(self, engine: str, n: int) -> list:
        """Digests of n seeded 8-character strings: no candidate of a
        mask of other than 8 positions can reach them."""
        words = [bytes(self.rng.integers(33, 127, 8, dtype=self.np.uint8))
                 for _ in range(n)]
        return self.get_engine(engine).hash_batch(words)

    def tables(self, engine: str, digests: list):
        """(the sorted table, the Bloom rows on the card -- None for a
        core without the sets, mysql323 -- the table on the card)."""
        table = self.make_target_table(digests, little_endian(engine))
        rows = None
        if self.cm.SETS in self.cm.core_modes(
                self.get_engine(engine, "cuda").core):
            rows = self.torch.as_tensor(
                self.bloom.bloom_tables(table.original_words())
                .view(self.np.int32), device="cuda")
        return table, rows, table.tensor("cuda")

    # -- phase 3: kernel vs plain -----------------------------------------

    def single_case(self, engine, gen, lut, start, n_valid, plant, cap,
                    want_lanes, name, fns=None, salt=None, key=None):
        """One single-target case: kernel and plain on the same inputs
        (``fns``: the pair, the mask kernel's by default; ``salt``: the
        target's salt, for a salted core; ``key``: the instantiation's
        name, when it is not the engine's)."""
        torch = self.torch
        kernel, plain = fns or (self.cm.mask_kernel, self.cm.mask_plain)
        params = None if salt is None else {"salt": salt}
        target = digest_words(engine, self.get_engine(engine).hash_batch(
            [gen.candidate(plant) if plant is not None
             else b"\0" * (gen.length + 1)], params=params)[0])
        args = (engine, lut, gen.radices, gen.digits(start), n_valid,
                *(() if salt is None else (salt,)), target, cap, BATCH)
        kc, kl = kernel(*args)
        pc, pl = plain(*args)
        torch.cuda.synchronize()
        kc, pc = int(kc.item()), int(pc.item())
        kl = sorted(int(x) for x in kl.cpu().tolist())
        pl = sorted(int(x) for x in pl.cpu().tolist())
        err = max([abs(kc - pc)] + [abs(a - b) for a, b in zip(kl, pl)])
        key = key or kname(engine, False)
        say(f"  {key} ({engine}) {name}: kernel count={kc} lanes="
            f"{[x for x in kl if x >= 0]} | plain count={pc} "
            f"lanes={[x for x in pl if x >= 0]}")
        check(kc == pc and kl == pl, f"{name}: kernel and plain differ")
        want_count = 0 if plant is None or not 0 <= plant - start < n_valid \
            else 1
        check(kc == want_count, f"{name}: count {kc}, expected {want_count}")
        check([x for x in kl if x >= 0] == sorted(want_lanes),
              f"{name}: lanes {kl}, expected {sorted(want_lanes)}")
        self.err[key] = max(self.err[key], err)

    def multi_case(self, engine, gen, lut, start, n_valid, plants, name,
                   n_targets=N_TARGETS, fns=None, key=None):
        """One multi-target case over n_targets targets: the planted
        candidates' digests first, then fillers (``fns``: the kernel and
        plain pair, the mask kernel's by default; ``key``: the
        instantiation's name, when it is not the engine's)."""
        kernel, plain = fns or (self.cm.mask_multi_kernel,
                                self.cm.mask_multi_plain)
        oracle = self.get_engine(engine)
        digests = oracle.hash_batch([gen.candidate(p) for p in plants])
        digests += self.fillers(engine, n_targets - len(plants))
        table, rows, words = self.tables(engine, digests)
        args = (engine, lut, gen.radices, gen.digits(start), n_valid, rows,
                words, 64, BATCH)
        k = kernel(*args)
        p = plain(*args)
        self.torch.cuda.synchronize()

        def flat(count, lanes, tpos, n_maybe):
            pairs = sorted((int(a), int(b)) for a, b in
                           zip(lanes.tolist(), tpos.tolist()))
            return int(count.item()), pairs, int(n_maybe.item())

        (kc, kp, km), (pc, pp, pm) = flat(*k), flat(*p)
        err = max([abs(kc - pc), abs(km - pm)]
                  + [abs(a - b) for x, y in zip(kp, pp)
                     for a, b in zip(x, y)])
        hits = [(l, int(table.order[t])) for l, t in kp if l >= 0]
        key = key or kname(engine, True)
        say(f"  {key} ({engine}) {name}: kernel count={kc} "
            f"(lane, target)={hits} n_maybe={km} | plain count={pc} "
            f"n_maybe={pm}")
        check((kc, kp, km) == (pc, pp, pm),
              f"{key} {name}: kernel and plain differ")
        want = [(p - start, i) for i, p in enumerate(plants)
                if 0 <= p - start < n_valid]
        check(hits == want, f"{name}: hits {hits}, expected {want}")
        check(km >= len(want), f"{name}: n_maybe {km} below the hits")
        self.err[key] = max(self.err[key], err)

    def group_case(self, kernel, plain, args, idx, want, key, name):
        """One grouped launch (the salted kernel's, krb5's): kernel and
        plain on the same inputs, equal count, (lane, target) pairs and
        per-target counts; ``want`` the (lane, job target) pairs,
        ``idx`` the group's job targets.  Returns the pairs."""
        def flat(count, lanes, tpos, tcount):
            pairs = sorted((int(a), idx[int(b)]) for a, b in
                           zip(lanes.tolist(), tpos.tolist()) if a >= 0)
            return int(count.item()), pairs, tcount.tolist()

        k = flat(*kernel(*args))
        p = flat(*plain(*args))
        self.torch.cuda.synchronize()
        err = max([abs(k[0] - p[0])]
                  + [abs(a - b) for x, y in zip(k[1], p[1])
                     for a, b in zip(x, y)]
                  + [abs(a - b) for a, b in zip(k[2], p[2])])
        say(f"  {key} {name}: kernel count={k[0]} (lane, target)={k[1]} | "
            f"plain count={p[0]} (lane, target)={p[1]}")
        check(k == p, f"{key} {name}: kernel and plain differ")
        check(want is None or k[1] == sorted(want),
              f"{key} {name}: hits {k[1]}, expected {want}")
        self.err[key] = max(self.err[key], err)
        return k[1]

    # -- phases 4-6: the CLI ----------------------------------------------

    def crack(self, cli, engine, mask, digests, planted, skip=0, limit=None):
        """crack --device cuda over [skip, skip + limit) with the launch
        counts set to 0 just before it; checks the found set, the
        potfile, the launches and the loop superstep's windows, and
        returns (summary, elapsed s)."""
        from dprf_tpu_torch.generators.mask import MaskGenerator
        from dprf_tpu_torch.runtime.potfile import encode_plain
        gen = MaskGenerator(mask)
        window = (limit if limit is not None else gen.keyspace - skip)
        unit = cli.UNIT_BATCHES * BATCH
        want_batches = sum(-(-min(unit, window - u) // BATCH)
                           for u in range(0, window, unit))
        oracle = self.get_engine(engine)
        want = sorted(f"{d.hex()}:{encode_plain(p)}" for d, p in
                      zip(oracle.hash_batch(planted), planted))
        multi = len(digests) > 1
        with tempfile.TemporaryDirectory() as tmp:
            hashfile = os.path.join(tmp, "hashes.txt")
            pot = os.path.join(tmp, "job.potfile")
            with open(hashfile, "w") as fh:
                fh.write("".join(d.hex() + "\n" for d in digests))
            argv = ["crack", "--device", "cuda", "--engine", engine, "-a",
                    "mask", mask, hashfile, "--potfile", pot, "--batch",
                    str(BATCH)]
            if skip:
                argv += ["--skip", str(skip)]
            if limit is not None:
                argv += ["--limit", str(limit)]
            self.cm.reset_launches()
            t0 = time.perf_counter()
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(argv)
            elapsed = time.perf_counter() - t0
            launches = dict(self.cm.launches)
            with open(pot) as fh:
                pot_lines = sorted(fh.read().splitlines())
        out, err = out.getvalue(), err.getvalue()
        name = kname(engine, multi)
        check(rc == 0, f"crack {engine} exited {rc}: {err[-2000:]}")
        check(sorted(out.splitlines()) == want,
              f"crack {engine} printed {out.splitlines()}, expected {want}")
        check(pot_lines == want, f"potfile holds {pot_lines}")
        finished = [ln for ln in err.splitlines() if "job finished" in ln]
        want_windows = unit_windows(cli, window)
        check(len(finished) == 1 and "rejected=0" in finished[0]
              and f"found={len(planted)}/{len(digests)}" in finished[0]
              and f"tested={window}" in finished[0]
              and f" batches={want_batches} " in finished[0]
              and f" windows={want_windows}" in finished[0],
              f"{name}: job summary {finished}, expected "
              f"{want_batches} batches in {want_windows} windows")
        check(launches[name] == want_batches and
              sum(launches.values()) == want_batches,
              f"{name}: launches {launches} for {want_batches} batches")
        self.path_launches[name] = launches[name]
        if name in PR8_WALL:
            self.loop_walls[name] = (elapsed, want_windows, want_batches)
        say(f"  {name}: {finished[0].split('job finished', 1)[1].strip()}")
        say(f"    wall {elapsed:.3f} s for {window} candidates = "
            f"{window / elapsed:,.0f} candidates/s (the whole CLI call); "
            f"{name} launches={launches[name]} batches={want_batches} "
            f"loop windows={want_windows}"
            + (f"; PR 8, one launch a batch: {PR8_WALL[name]:.3f} s"
               if name in PR8_WALL else ""))
        return finished[0], elapsed

    # -- phase 8: the rule kernel vs plain ----------------------------------

    def rules_case(self, engine, gen, tables, ws, n_valid, plants, name,
                   rejected=(), core=None) -> float:
        """One rule-kernel case over words [ws, ws + n_valid) x every
        rule: kernel and plain on the same inputs (``tables``: the
        kernel's padded word table, the plain version's, lens, bytecode,
        n_ops), with the digest of the candidate at keyspace index
        plants[0] as target.  Every index of ``plants`` must come back
        as a hit lane; every word index (a rule's candidate that
        rejects) of ``rejected`` must not.  ``core``: the instantiation
        the engine runs, when it is not the engine's name (a sha3 name
        runs its rate's keccak core).  Returns the plain version's ms."""
        from dprf_tpu_torch.ops import cuda_rules
        plain = gen.candidate(plants[0])
        target = digest_words(engine,
                              self.get_engine(engine).hash_batch([plain])[0])
        padded, plain_t, *rest = tables
        tail = (ws, n_valid, target, 64, RULE_BATCH)
        kc, kl = cuda_rules.rules_kernel(engine, padded, *rest, *tail,
                                         max_len=gen.max_len)
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        pc, pl = cuda_rules.rules_plain(engine, plain_t, *rest, *tail)
        self.torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        kc, pc = int(kc.item()), int(pc.item())
        kl = sorted(int(x) for x in kl.cpu().tolist())
        pl = sorted(int(x) for x in pl.cpu().tolist())
        err = max([abs(kc - pc)] + [abs(a - b) for a, b in zip(kl, pl)])
        hits = [x for x in kl if x >= 0]
        gidx = [(ws + x % RULE_BATCH) * gen.n_rules + x // RULE_BATCH
                for x in hits]
        key = rname(core or engine)
        say(f"  {key} ({engine}) {name}: kernel count={kc} lanes="
            f"{hits[:8]} | plain count={pc}; target {plain[:24]!r}, "
            f"{len(plain)} bytes")
        check(kc == pc and kl == pl, f"{name}: kernel and plain differ")
        check(0 < kc <= 64, f"{name}: count {kc}")
        check(all(p in gidx for p in plants),
              f"{name}: planted {plants} not all in {gidx}")
        check(all(gen.candidate(g) == plain for g in gidx),
              f"{name}: a hit lane decodes to another candidate")
        check(not any(r in gidx for r in rejected),
              f"{name}: a rejected candidate hit")
        self.err[key] = max(self.err[key], err)
        return plain_ms

    @staticmethod
    def rules_pair(engine, tables, max_len, ws, n_valid, target, word_batch,
                   cap=64, run=None):
        """The rule kernel on the padded table and its plain version on
        the table of max_len-byte rows, same job: ((count, lanes),
        (count, lanes)), still being computed.  run: the kernel's rules a
        thread, by default its host's choice."""
        from dprf_tpu_torch.ops import cuda_rules
        padded, plain, *rest = tables
        tail = (ws, n_valid, target, cap, word_batch)
        return (cuda_rules.rules_kernel(engine, padded, *rest, *tail,
                                        max_len=max_len, run=run),
                cuda_rules.rules_plain(engine, plain, *rest, *tail))

    def rules_equal(self, engine, tables, max_len, ws, nv, wb, want, what,
                    run=None) -> int:
        """One launch whose target is the digest of ``want``: the count
        and the lanes must equal the plain version's, and hit.  Returns
        the count."""
        target = digest_words(
            engine, self.get_engine(engine).hash_batch([want])[0])
        n_rules = tables[3].shape[0]
        (kc, kl), (pc, pl) = self.rules_pair(
            engine, tables, max_len, ws, nv, target, wb, cap=wb * n_rules,
            run=run)
        self.torch.cuda.synchronize()
        k = (int(kc.item()), sorted(x for x in kl.tolist() if x >= 0))
        p = (int(pc.item()), sorted(x for x in pl.tolist() if x >= 0))
        check(k == p and k[0] > 0,
              f"{rname(engine)} max_len {max_len} {what}, target "
              f"{want!r}: kernel {k}, plain {p}")
        return k[0]

    def rules_all_ops(self, engine, max_len) -> tuple:
        """Every opcode the kernel takes (RULES_ALL_OPS) at max_len over
        RULE_WORDS and a random word of every length 0..max_len, the
        window cut mid-warp (words 3 .. n - 2), the hit capacity every
        lane; kernel and plain must agree exactly on count and lanes.
        Each rule alone, a launch for each length class of its
        candidates (0, 1, 3-5, 15-17, max_len - 1, max_len; a random
        candidate of the class as target); then all the rules as one run
        of a thread, a launch a rule, the target its candidate of the
        word whose candidate under the rule before is longest, so the
        restore between rules has the most to undo.  Returns (rules,
        launches, hits)."""
        import numpy as np

        from dprf_tpu_torch.generators.wordlist import \
            WordlistRulesGenerator
        from dprf_tpu_torch.ops import cuda_rules
        from dprf_tpu_torch.rules.parser import parse_rules
        torch, rng = self.torch, self.rng
        rules = parse_rules(RULES_ALL_OPS)
        check(cuda_rules.rules_supported(rules)
              and len(rules) <= cuda_rules.MAX_RUN,
              "RULES_ALL_OPS holds an op the kernel refuses, or more rules "
              "than a run")
        words = [w for w in RULE_WORDS if len(w) <= max_len] + [
            bytes(rng.integers(0, 256, n, dtype=np.uint8))
            for n in range(max_len + 1)]
        gen = WordlistRulesGenerator(words, rules, max_len)
        buf, lens = gen.packed_words()
        plain = torch.as_tensor(buf, device="cuda")
        words_t = (cuda_rules.pad_rows(plain), plain,
                   torch.as_tensor(lens, device="cuda"))
        ws, nv = 3, len(words) - 5
        wb = -(-nv // 32) * 32
        # cands[r][b]: rule r's candidate of window word b, None = rejected
        cands = [[gen.candidate(gen.index_of(ws + b, r)) for b in range(nv)]
                 for r in range(len(rules))]
        classes = ((0, 0), (1, 1), (3, 5), (15, 17),
                   (max_len - 1, max_len - 1), (max_len, max_len))
        launches = hits = 0
        for r, line in enumerate(RULES_ALL_OPS):
            one = (*words_t, *cuda_rules.rule_tables([rules[r]], "cuda"))
            for lo, hi in classes:
                pool = sorted({c for c in cands[r]
                               if c is not None and lo <= len(c) <= hi})
                if pool:
                    hits += self.rules_equal(
                        engine, one, max_len, ws, nv, wb,
                        pool[int(rng.integers(0, len(pool)))],
                        f"rule {line!r} alone")
                    launches += 1
        tables = (*words_t, *cuda_rules.rule_tables(rules, "cuda"))
        for r, line in enumerate(RULES_ALL_OPS):
            prev = [len(c) if c is not None else -1
                    for c in cands[r - 1]] if r else [0] * nv
            live = [b for b in range(nv) if cands[r][b] is not None]
            if live:
                b = max(live, key=lambda b: (prev[b], -b))
                hits += self.rules_equal(
                    engine, tables, max_len, ws, nv, wb, cands[r][b],
                    f"rule {line!r} in one run of {len(rules)} rules",
                    run=len(rules))
                launches += 1
        return len(rules), launches, hits

    # -- phase 9: config 3 through the CLI -----------------------------------

    def crack_words(self, cli, engine, words_path, n_words, digest,
                    planted, max_len=55):
        """crack --device cuda -a wordlist --rules best64 with the launch
        counts set to 0 just before it; checks the found set, the
        summary (tested, rejected=0, batches) and that only the engine's
        rule kernel launched, once per word window; returns (summary,
        wall s)."""
        from dprf_tpu_torch.ops import cuda_mask, cuda_rules
        from dprf_tpu_torch.runtime.potfile import encode_plain
        keyspace = n_words * N_RULES
        unit = cli.UNIT_BATCHES * BATCH // N_RULES * N_RULES
        want_batches = 0
        for start in range(0, keyspace, unit):
            w0, w1 = start // N_RULES, -(-min(start + unit, keyspace)
                                        // N_RULES)
            want_batches += -(-(w1 - w0) // RULE_BATCH)
        want = [] if planted is None else \
            [f"{digest.hex()}:{encode_plain(planted)}"]
        with tempfile.TemporaryDirectory() as tmp:
            hashfile = os.path.join(tmp, "hashes.txt")
            with open(hashfile, "w") as fh:
                fh.write(digest.hex() + "\n")
            argv = ["crack", "--engine", engine, "-a", "wordlist",
                    words_path, hashfile, "--rules", "best64", "--device",
                    "cuda", "--potfile", os.path.join(tmp, "job.potfile")]
            cuda_mask.reset_launches()
            cuda_rules.reset_launches()
            t0 = time.perf_counter()
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(argv)
            elapsed = time.perf_counter() - t0
            launches = {**cuda_mask.launches, **cuda_rules.launches}
        out, err = out.getvalue(), err.getvalue()
        name = rname(engine)
        check(rc == (0 if want else 1),
              f"crack -a wordlist {engine} exited {rc}: {err[-2000:]}")
        check(out.splitlines() == want,
              f"crack {engine} printed {out.splitlines()}, expected {want}")
        finished = [ln for ln in err.splitlines() if "job finished" in ln]
        summary = finished[0] if len(finished) == 1 else ""
        ok = "rejected=0" in summary and f"found={len(want)}/1" in summary
        if planted is None:         # a full sweep
            ok = ok and all(f in summary for f in (
                f"tested={keyspace}", "exhausted=True",
                f" batches={want_batches}"))
        check(ok, f"{name}: job summary {finished}, expected "
              f"{want_batches} batches")
        check(launches[name] == sum(launches.values()) > 0
              and (planted is not None or launches[name] == want_batches),
              f"{name}: launches {launches}, {want_batches} word windows")
        self.path_launches.setdefault(name, launches[name])
        say(f"  {name}: {finished[0].split('job finished', 1)[1].strip()}")
        say(f"    wall {elapsed:.3f} s for {keyspace} candidates = "
            f"{keyspace / elapsed:,.0f} candidates/s (the whole CLI call); "
            f"{name} launches={launches[name]}")
        return finished[0], elapsed

    # -- phase 11: the PMKID kernel vs plain -----------------------------

    def pmkid_targets(self, essid, plants, iterations):
        """Targets of one ESSID group, each (plaintext, AP, STA) ->
        Target, their lines made by hashlib."""
        eng = self.get_engine("wpa2-pmkid")
        return [eng.parse_target(pmkid_line(p, essid, ap, sta, iterations))
                for p, ap, sta in plants]

    def pmkid_case(self, gen, lut, start, n_valid, essid, targets, want,
                   name, iters=PMKID_CHECK_ITERS, batch=PMKID_CHECK_BATCH,
                   plain=True):
        """One PMKID case: the kernel (and its plain version) over one
        ESSID group; ``want`` the (lane, target) hits."""
        from dprf_tpu_torch.ops import cuda_pbkdf2
        table = cuda_pbkdf2.target_table(targets, "cuda")
        args = (lut, gen.radices, gen.digits(start), n_valid, essid, iters,
                table, 64, batch)
        k = cuda_pbkdf2.pmkid_kernel(*args)
        p = cuda_pbkdf2.pmkid_plain(*args) if plain else None
        self.torch.cuda.synchronize()

        def flat(count, lanes, tidx):
            return int(count.item()), sorted(
                (int(a), int(b)) for a, b in zip(lanes.tolist(),
                                                 tidx.tolist()) if a >= 0)

        kf = flat(*k)
        msg = f"  pmkid {name}: kernel count={kf[0]} (lane, target)={kf[1]}"
        if plain:
            pf = flat(*p)
            say(f"{msg} | plain count={pf[0]} (lane, target)={pf[1]}")
            check(kf == pf, f"pmkid {name}: kernel and plain differ")
            err = max([abs(kf[0] - pf[0])] + [abs(a - b) for x, y in
                                              zip(kf[1], pf[1])
                                              for a, b in zip(x, y)])
            self.err["pmkid"] = max(self.err["pmkid"], err)
        else:
            say(f"{msg} | hashlib planted {sorted(want)}")
        check(kf == (len(want), sorted(want)),
              f"pmkid {name}: hits {kf}, expected {sorted(want)}")

    def crack_lines(self, cli, engine, argv, lines, want, window, kernels,
                    same=None):
        """crack --device cuda over a file of target lines: argv, the
        attack's options then its mask or wordlist.  The launch counts
        of the ``kernels`` modules are set to 0 just before it.  Checks
        the printed lines and the potfile (``want``), rejected=0 and
        tested=``window``; returns (summary, wall s, launches)."""
        with tempfile.TemporaryDirectory() as tmp:
            hashfile = os.path.join(tmp, "hashes.txt")
            pot = os.path.join(tmp, "job.potfile")
            with open(hashfile, "w") as fh:
                fh.write("".join(ln + "\n" for ln in lines))
            *opts, attack_arg = argv
            args = ["crack", "--device", "cuda", "--engine", engine, *opts,
                    attack_arg, hashfile, "--potfile", pot]
            for mod in kernels:
                mod.reset_launches()
            t0 = time.perf_counter()
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(args)
            elapsed = time.perf_counter() - t0
            launches = {k: v for mod in kernels
                        for k, v in mod.launches.items()}
            pot_lines = open(pot).read().splitlines() \
                if os.path.exists(pot) else []
        out, err = out.getvalue(), err.getvalue()
        check(rc == (0 if want else 1),
              f"crack {engine} exited {rc}: {err[-2000:]}")
        same = same or (lambda got, want: sorted(got) == sorted(want))
        check(same(out.splitlines(), want),
              f"crack {engine} printed {out.splitlines()}, expected {want}")
        check(same(pot_lines, want), f"potfile {pot_lines}")
        finished = [ln for ln in err.splitlines() if "job finished" in ln]
        check(len(finished) == 1 and "rejected=0" in finished[0]
              and f"found={len(want)}/{len(lines)}" in finished[0]
              and f"tested={window}" in finished[0],
              f"{engine}: job summary {finished}")
        say(f"  {engine}: {finished[0].split('job finished', 1)[1].strip()}")
        say(f"    wall {elapsed:.3f} s for {window} candidates; launches "
            f"{launches}")
        return finished[0], elapsed, launches

    # -- phase 7: timing --------------------------------------------------

    def time_launches(self, fn, args, n=TIMED_LAUNCHES, warm=3) -> float:
        """ms per launch, CUDA events over n launches after warm-up."""
        torch = self.torch
        for _ in range(warm):
            fn(*args)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn(*args)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / n

    def time_clocked(self, fn, args, seconds=0.4, chunk=32) -> tuple:
        """(ms per launch, the SM clock in MHz): launches for ``seconds``
        of wall clock, CUDA events around each chunk of ``chunk``
        launches (enough that the host's time before a chunk's first
        launch is noise), the clock sampled by nvidia-smi meanwhile
        (``SmClock``)."""
        fn(*args)
        self.torch.cuda.synchronize()
        with SmClock() as clock:
            ms, _ = busy(self.torch, lambda: fn(*args), seconds, chunk)
        check(clock.mhz is not None, "nvidia-smi gave no SM clock sample")
        return ms, clock.mhz

    def time_once(self, fn, args, warm=True) -> float:
        """ms of one call, after one warm-up call (if warm)."""
        torch = self.torch
        if warm:
            fn(*args)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(*args)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card: torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dprf_tpu_torch  # noqa: F401  (the checkout's port, or fail)

    smoke = Smoke()
    # config 4's planted target line: the pure-Python oracle takes tens
    # of seconds at cost 12, so it starts now, in the background
    words4 = synthetic_words(CONFIG4_WORDS)
    oracle4 = subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from dprf_tpu_torch.engines.cpu.bcrypt import "
         "bcrypt_hash; print(bcrypt_hash(bytes.fromhex(sys.argv[1]), "
         "bytes(range(16)), int(sys.argv[2])))",
         words4[-1].hex(), str(CONFIG4_COST)],
        stdout=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        run(smoke, oracle4, words4)
    finally:
        if oracle4.poll() is None:
            oracle4.kill()
        oracle4.wait()


def run(smoke, oracle4, words4) -> None:
    import numpy as np
    import torch

    from dprf_tpu_torch import cli
    from dprf_tpu_torch.engines.base import Target
    from dprf_tpu_torch.engines.cpu.bcrypt import bcrypt_hash, bcrypt_raw
    from dprf_tpu_torch.engines.cpu.engines import Md5Engine, Pmkid2Engine
    from dprf_tpu_torch.engines.device.engines import TorchMd5Engine
    from dprf_tpu_torch.generators.mask import MaskGenerator
    from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
    from dprf_tpu_torch.ops import (_build, blowfish, bloom, cuda_7z,
                                    cuda_bcrypt, cuda_ext, cuda_keccak,
                                    cuda_krb5, cuda_mask, cuda_pbkdf2,
                                    cuda_pdf, cuda_rules, opcount)
    from dprf_tpu_torch.rules import load_rules
    from dprf_tpu_torch.runtime.worker import CudaMaskWorker
    from dprf_tpu_torch.runtime.workunit import WorkUnit

    rng = smoke.rng

    # 1. the card
    phase(1)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"== card: {kind}  devices={count}  torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    say(card)
    say(f"  SMs={sms}  max SM clock={clock_mhz:.0f} MHz")

    # 2. the kernel builds: one nvcc per source, all at once
    phase(2)
    build_all(smoke, sms)
    wave = cuda_bcrypt.resident_batch("cuda")

    # 3. kernel vs plain on the card
    phase(3)
    say(f"== kernel vs plain at batch {BATCH} (exact equality)")
    g6 = MaskGenerator(MASK_CONFIG1)
    lut6 = g6.charset_lut("cuda")
    g7 = MaskGenerator(MASK_CONFIG2)
    lut7 = g7.charset_lut("cuda")
    g8 = MaskGenerator(MASK_BENCH)
    lut8 = g8.charset_lut("cuda")
    s = 5 * BATCH
    smoke.single_case("md5", g6, lut6, s, BATCH, s, 64, [0],
                      "?l^6 hit at lane 0")
    s = (g6.keyspace // BATCH) * BATCH
    nv = g6.keyspace - s
    smoke.single_case("md5", g6, lut6, s, nv, g6.keyspace - 1, 64, [nv - 1],
                      f"?l^6 hit at last valid lane, n_valid={nv}")
    smoke.single_case("md5", g6, lut6, 7 * BATCH, BATCH, None, 64, [],
                      "?l^6 no hit")
    s = int(rng.integers(0, g8.keyspace - BATCH))
    lane = int(rng.integers(0, BATCH))
    smoke.single_case("md5", g8, lut8, s, BATCH, s + lane, 64, [lane],
                      f"?a^8 random base {s}")
    s = 11 * BATCH
    smoke.single_case("md5", g6, lut6, s, BATCH, s + 12345, 0, [],
                      "?l^6 hit_capacity=0")
    # the worker's overflow contract: count 1 > capacity 0 -> rescan
    plant = s + 12345
    digest = hashlib.md5(g6.candidate(plant)).digest()
    w = CudaMaskWorker(TorchMd5Engine(), g6, [Target(digest.hex(), digest)],
                       batch=BATCH, hit_capacity=0, oracle=Md5Engine())
    hits = w.process(WorkUnit(0, plant - 100, 4096))
    check([(h.cand_index, h.plaintext) for h in hits]
          == [(plant, g6.candidate(plant))],
          f"hit_capacity=0 worker rescan returned {hits}")
    say(f"  worker rescan with hit_capacity=0 found {hits[0].plaintext!r}"
        f" at {plant}")
    base = int(rng.integers(0, g7.keyspace // BATCH - 2)) * BATCH
    nv = BATCH - 1000
    for engine in ("ntlm", "sha1", "sha256"):
        smoke.single_case(engine, g7, lut7, base, BATCH, base, 64, [0],
                          "?a^7 hit at lane 0")
        smoke.single_case(engine, g7, lut7, base + BATCH, nv,
                          base + BATCH + nv - 1, 64, [nv - 1],
                          f"?a^7 hit at last valid lane, n_valid={nv}")
        smoke.single_case(engine, g7, lut7, base, BATCH, None, 64, [],
                          "?a^7 no hit")
    for engine in ("md5", "ntlm", "sha1", "sha256"):
        smoke.multi_case(engine, g7, lut7, base, nv,
                         [base, base + 64, base + 65, base + nv - 1,
                          base + nv], "?a^7 hits at lanes 0, 64, 65, "
                         f"n_valid-1 and n_valid={nv}")
        smoke.multi_case(engine, g7, lut7, base + BATCH, BATCH, [base],
                         "?a^7 no hit")
    # the largest shared memory a block takes: 55 positions, 8 sets
    g55 = MaskGenerator("?a" * 7 + "?d" * 48)
    s = int(rng.integers(0, 1 << 62)) * BATCH
    nv = BATCH - 7
    smoke.multi_case("md5", g55, g55.charset_lut("cuda"), s, nv,
                     [s, s + 1, s + nv - 1], f"?a^7?d^48 at "
                     f"{bloom.MAX_TARGETS} targets, hits at lanes 0, 1 and "
                     f"n_valid-1={nv - 1}", n_targets=bloom.MAX_TARGETS)
    # slice K2's runs of lanes: the hits straddle a carry of position
    # L - 2 into L - 3 between two runs (lanes X - 1 and X), the window
    # starts at an offset no run length divides and n_valid ends inside
    # a run; one target, the Bloom sets and the probe, a 55-position mask,
    # a wide core (one lane a thread) and a nested chain
    offset, nv = 12347, BATCH - 17
    X = offset + 3 * 4096 + 5
    for gen, lut, engine, mode in ((g7, lut7, "md5", 0), (g7, lut7, "md5", 1),
                                   (g7, lut7, "ntlm", 0),
                                   (g7, lut7, "ntlm", 1),
                                   (g7, lut7, "ntlm", PROBE),
                                   (g55, g55.charset_lut("cuda"), "md5", 1),
                                   (g7, lut7, "sha512", 0)):
        start = carry_start(rng, gen, X)
        runs = cuda_mask.lanes_a_run(engine, gen.radices) > 1
        for first in ((X - 1, X) if mode == 0 and runs else (X - 1,)):
            # one target: the first plant; a list: the plants by lane
            plants = [start + first, start + X, start + offset,
                      start + nv - 1, start + nv, start + offset - 1]
            window_case(
                smoke, engine, mode, gen, lut, start, offset, nv,
                plants if mode == 0 else sorted(plants),
                f"{gen.mask[:16]}{'...' if gen.length > 8 else ''}, the "
                f"carry into position {gen.length - 3} between lanes "
                f"{X - 1} and {X}, window [{offset}, {nv})"
                + (f", target lane {first}" if mode == 0 else ""))
    start = carry_start(rng, g7, X)
    smoke.multi_case("md5(md5)", g7, lut7, start, nv,
                     [start + X - 1, start + X, start + nv - 1, start + nv],
                     f"?a^7, the carry into position 4 between lanes {X - 1}"
                     f" and {X}, n_valid={nv}",
                     fns=(cuda_ext.nested_multi_kernel,
                          cuda_ext.nested_multi_plain),
                     key="md5(md5)_mask_multi")

    # 4. config 1: the whole ?l^6 keyspace
    phase(4)
    say("== config 1: crack --device cuda --engine md5 -a mask ?l^6")
    plain = g6.candidate(g6.keyspace - 1)
    smoke.crack(cli, "md5", MASK_CONFIG1, [hashlib.md5(plain).digest()],
                [plain])

    # 5. config 2 at full width
    phase(5)
    say("== config 2: crack --device cuda --engine ntlm -a mask ?a^7, "
        f"{N_TARGETS} targets, a window of {CONFIG2_WINDOW} candidates")
    skip = int(rng.integers(0, g7.keyspace - CONFIG2_WINDOW))
    within = sorted({int(x) for x in rng.integers(1, CONFIG2_WINDOW - 1, 5)})
    b = within[0] // BATCH * BATCH
    idx = sorted({0, CONFIG2_WINDOW - 1, b + 100, b + 101, *within[1:]})
    check(len(idx) == 8, f"planted indices collide: {idx}")
    planted = [g7.candidate(skip + i) for i in idx]
    ntlm = smoke.get_engine("ntlm")
    digests = ntlm.hash_batch(planted) + smoke.fillers("ntlm", N_TARGETS - 8)
    order = rng.permutation(N_TARGETS)
    digests = [digests[i] for i in order]
    rows = bloom.bloom_tables(smoke.make_target_table(digests).
                              original_words())
    fill = np.unpackbits(rows.view(np.uint8), axis=1).sum(axis=1) / 4096
    p_false = float(np.prod(fill))
    say(f"  planted at window offsets {idx} (skip {skip}); Bloom rows "
        f"{fill.min():.3f}-{fill.max():.3f} full, a non-matching "
        f"candidate passes with p={p_false:.3e}: predicted "
        f"{p_false * BATCH:.1f} false maybes per batch of {BATCH}")
    summary, elapsed = smoke.crack(cli, "ntlm", MASK_CONFIG2, digests,
                                   planted, skip=skip, limit=CONFIG2_WINDOW)
    maybes = int(re.search(r"maybes=(\d+)", summary).group(1))
    batches = smoke.path_launches["ntlm_mask_multi"]
    rate = re.search(r" rate=([\d,]+)/s", summary).group(1)
    say(f"  config 2: {elapsed:.3f} s wall, the coordinator's loop "
        f"{rate} candidates/s; Bloom maybes {maybes} = "
        f"{maybes / batches:.2f} per batch (predicted "
        f"{p_false * BATCH + 8 / batches:.2f} with the 8 real hits); "
        f"card: {card}")
    say(json.dumps({"config2": {
        "wall_s": elapsed, "maybes": maybes, "batches": batches,
        "p_false": p_false, "skip": skip, "window": CONFIG2_WINDOW}}))

    # 6. the other instantiations end to end, each over 16 batches
    phase(6)
    say("== the other instantiations: crack --device cuda over "
        f"{OTHER_WINDOW} candidates of ?a^7")
    for engine, multi in INSTANCES:
        if kname(engine, multi) in smoke.path_launches:
            continue
        skip = int(rng.integers(0, g7.keyspace - OTHER_WINDOW))
        plant = g7.candidate(skip + int(rng.integers(0, OTHER_WINDOW)))
        digests = smoke.get_engine(engine).hash_batch([plant])
        if multi:
            digests += smoke.fillers(engine, N_TARGETS - 1)
        smoke.crack(cli, engine, MASK_CONFIG2, digests, [plant], skip=skip,
                    limit=OTHER_WINDOW)

    # 7. timing at batch 2^24
    phase(7)
    say(f"== timing at batch 2^24 (CUDA events over 0.4 s of launches, the "
        f"SM clock sampled meanwhile); card: {card}")
    rate_ops = sms * LANES_PER_SM * clock_mhz * 1e6
    smoke.clock_mhz = clock_mhz
    timing = {}
    for engine, multi in INSTANCES:
        gen, lut = (g6, lut6) if engine == "md5" and not multi \
            else (g7, lut7)
        start = int(rng.integers(0, gen.keyspace // BATCH)) * BATCH
        if multi:
            table, rows, words = smoke.tables(
                engine, smoke.fillers(engine, N_TARGETS))
            args = (engine, lut, gen.radices, gen.digits(start), BATCH,
                    rows, words, 64, BATCH)
            fn, plain_fn = cuda_mask.mask_multi_kernel, \
                cuda_mask.mask_multi_plain
            n_maybe = int(fn(*args)[3].item())
            probes = bloom.expected_probes(rows.cpu().numpy()
                                           .view(np.uint32))
            work = opcount.ops_per_candidate(
                engine, gen.length, True, probes, n_maybe / BATCH, N_TARGETS,
                run=cuda_mask.lanes_a_run(engine, gen.radices))
        else:
            miss = digest_words(engine, smoke.get_engine(engine)
                                .hash_batch([b"\0" * 9])[0])
            args = (engine, lut, gen.radices, gen.digits(start), BATCH,
                    miss, 64, BATCH)
            fn, plain_fn = cuda_mask.mask_kernel, cuda_mask.mask_plain
            work = opcount.ops_per_candidate(
                engine, gen.length,
                run=cuda_mask.lanes_a_run(engine, gen.radices))
        ms, mhz = smoke.time_clocked(fn, args)
        plain_ms = smoke.time_once(plain_fn, args)
        bound = BATCH * work.slots / rate_ops * 1e3
        key = kname(engine, multi)
        timing[key] = (ms, plain_ms, bound,
                       clock_keys(bound, mhz, clock_mhz))
        say(f"  {key} {gen.mask}: {ms:.4f} ms/launch = "
            f"{BATCH / ms / 1e6:.3f} G candidates/s (parent "
            f"{PARENT_MS[key]:.4f} ms, x{PARENT_MS[key] / ms:.3f}); bound "
            f"{bound:.4f} ms at {clock_mhz:.0f} MHz, "
            f"{bound * clock_mhz / mhz:.4f} ms at the sampled {mhz:.0f} MHz "
            f"(per candidate {work.alu:.1f} ALU, {work.add:.1f} IADD3, "
            f"{work.fma:.1f} IMAD = {work.slots:.1f} slots at runs of "
            f"{cuda_mask.lanes_a_run(engine, gen.radices):.2f} lanes; "
            f"kernel at "
            f"{bound / ms:.1%} / {bound * clock_mhz / mhz / ms:.1%} of "
            f"it); plain version {plain_ms:.3f} ms")
    ms8 = smoke.time_launches(cuda_mask.mask_kernel, (
        "md5", lut8, g8.radices, g8.digits(0), BATCH,
        digest_words("md5", hashlib.md5(b"\0" * 9).digest()), 64, BATCH))
    say(f"  md5_mask {MASK_BENCH}: {ms8:.4f} ms/launch = "
        f"{BATCH / ms8 / 1e6:.3f} G candidates/s")
    say(f"  bound: slots/candidate x 2^24 / ({sms} SMs x "
        f"{LANES_PER_SM} lanes x {clock_mhz:.0f} MHz), slots from "
        "ops/opcount.py")
    for engine, mask in (("md5", MASK_BENCH), ("ntlm", MASK_CONFIG2)):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main(["bench", "--engine", engine, "--mask", mask,
                           "--device", "cuda", "--seconds", "2"])
        say(out.getvalue().strip())
        check(rc == 0, f"bench exited {rc}: {err.getvalue()}")
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        check(res["hits"] == 0, "bench found a hit on an unreachable target")

    # 8. the rule kernel vs its plain version at 2^24 candidates a launch
    phase(8)
    say(f"== rule kernel vs plain at {RULE_BATCH} words x {N_RULES} rules "
        f"= {RULE_BATCH * N_RULES} candidates a launch (exact equality)")
    t0 = time.perf_counter()
    words3 = synthetic_words(CONFIG3_WORDS)
    say(f"  the synthetic list: {len(words3)} words in "
        f"{time.perf_counter() - t0:.2f} s (the reference bench's LCG)")
    best64 = load_rules("best64")
    check(len(best64) == N_RULES, f"best64 has {len(best64)} rules")
    check(len(best64[RULE_8OPS]) == 8 and len(best64[RULE_4OPS]) == 4,
          "best64's 8-op / 4-op rules moved")
    rule_gens, rule_tables = {}, {}
    for max_len in (27, 55):
        gen = WordlistRulesGenerator(words3, best64, max_len=max_len)
        buf, lens = gen.packed_words()
        rule_gens[max_len] = gen
        # the kernel's table (rows padded to 16 bytes), the plain's
        plain = torch.as_tensor(buf, device="cuda")
        rule_tables[max_len] = (
            cuda_rules.pad_rows(plain), plain,
            torch.as_tensor(lens, device="cuda"),
            *cuda_rules.rule_tables(best64, "cuda"))
    # a list whose rows are 16 bytes wide: "p2 '7 p1 x58" grows its
    # 8-byte words to 24 bytes on the way, so each such candidate rejects
    gen16 = WordlistRulesGenerator(words3[:RULE_BATCH], best64, max_len=16)
    buf16, lens16 = gen16.packed_words()
    plain16 = torch.as_tensor(buf16, device="cuda")
    tables16 = (cuda_rules.pad_rows(plain16), plain16,
                torch.as_tensor(lens16, device="cuda"),
                *cuda_rules.rule_tables(best64, "cuda"))
    n3 = CONFIG3_WORDS
    for engine in RULE_CORES:
        max_len = 27 if engine == "ntlm" else 55
        gen, tables = rule_gens[max_len], rule_tables[max_len]
        smoke.rules_case(engine, gen, tables, 0, RULE_BATCH, [0],
                         "word 0 under rule 0")
        nv = RULE_BATCH - 777
        ws = n3 - nv
        smoke.rules_case(engine, gen, tables, ws, nv,
                         [gen.index_of(n3 - 1, RULE_8OPS)],
                         f"the last word under the 8-op rule, window of "
                         f"{nv} words at {ws}")
        ws = 12345
        w = ws + int(rng.integers(0, RULE_BATCH))
        smoke.rules_case(engine, gen, tables, ws, RULE_BATCH,
                         [gen.index_of(w, int(rng.integers(0, N_RULES)))],
                         f"a window at word {ws}")
        w = ws + int(rng.integers(0, RULE_BATCH))
        smoke.rules_case(engine, gen, tables, ws, RULE_BATCH,
                         [gen.index_of(w, RULE_TRUNC7),
                          gen.index_of(w, RULE_DEL_LAST)],
                         f"the \"'7\" / \"]\" pair of word {w}")
        # the target is word w's candidate under the grow rule at
        # max_len 55; at 16 that candidate rejects, so no lane of the
        # grow rule may hit
        w = int(rng.integers(0, RULE_BATCH))
        plant = rule_gens[55].candidate(rule_gens[55].index_of(w,
                                                               RULE_GROW24))
        check(gen16.candidate(gen16.index_of(w, RULE_GROW24)) is None,
              "the grow rule did not reject at max_len 16")
        target = digest_words(engine,
                              smoke.get_engine(engine).hash_batch([plant])[0])
        k, p = smoke.rules_pair(engine, tables16, 16, 0, RULE_BATCH, target,
                                RULE_BATCH)
        torch.cuda.synchronize()
        k = (int(k[0].item()), sorted(k[1].cpu().tolist()))
        p = (int(p[0].item()), sorted(p[1].cpu().tolist()))
        check(k == p, f"{rname(engine)} max_len 16: kernel {k}, plain {p}")
        check(all(x // RULE_BATCH != RULE_GROW24 for x in k[1] if x >= 0),
              f"{rname(engine)}: a rejected candidate hit")
        say(f"  {rname(engine)} max_len 16, target {plant!r} whose rule "
            f"rejects there: kernel count={k[0]} | plain count={p[0]}")
        for ml in RULES_ALL_OPS_MAX_LEN.get(engine, (16, 55)):
            t0 = time.perf_counter()
            n_r, n_l, n_hits = smoke.rules_all_ops(engine, ml)
            say(f"  {rname(engine)} every opcode at max_len {ml}: {n_r} "
                f"rules, each alone at every length class and all as one "
                f"run, {n_l} launches, {n_hits} hits, kernel == plain "
                f"({time.perf_counter() - t0:.1f} s)")

    # 9. config 3 at full width, then the other rule cores
    phase(9)
    say(f"== config 3: crack --device cuda --engine sha256 -a wordlist "
        f"--rules best64, {CONFIG3_WORDS} words; card: {card}")
    with tempfile.TemporaryDirectory() as tmp:
        path3 = os.path.join(tmp, "words.txt")
        t0 = time.perf_counter()
        with open(path3, "wb") as fh:
            fh.write(b"\n".join(words3) + b"\n")
        t1 = time.perf_counter()
        loaded = WordlistRulesGenerator.from_files(path3, "best64")
        t2 = time.perf_counter()
        check(loaded.n_words == CONFIG3_WORDS
              and loaded.keyspace == CONFIG3_WORDS * N_RULES,
              f"config 3 list: {loaded.n_words} words")
        t3 = time.perf_counter()
        dev = torch.as_tensor(loaded.packed_words()[0], device="cuda")
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        del dev
        say(f"  set-up parts: write the list {t1 - t0:.3f} s, load it "
            f"(numpy loader) {t2 - t1:.3f} s, upload its table "
            f"{t4 - t3:.3f} s")
        miss = hashlib.sha256(b"\0" * 9).digest()
        summary, wall = smoke.crack_words(cli, "sha256", path3, n3, miss,
                                          None)
        rate = re.search(r" rate=([\d,]+)/s", summary).group(1)
        loop = n3 * N_RULES / int(rate.replace(",", ""))
        say(f"  config 3 sweep: {wall:.3f} s wall, loop {loop:.3f} s at "
            f"{rate} candidates/s, set-up {wall - loop:.3f} s; card: {card}")
        config3 = {"wall_s": wall, "loop_s": loop, "setup_s": wall - loop,
                   "load_s": t2 - t1, "upload_s": t4 - t3,
                   "candidates": n3 * N_RULES}
        plant = rule_gens[55].candidate(rule_gens[55].index_of(n3 - 1,
                                                               RULE_4OPS))
        summary, wall_b = smoke.crack_words(
            cli, "sha256", path3, n3, hashlib.sha256(plant).digest(),
            plant)
        config3["planted_wall_s"] = wall_b
        say(json.dumps({"config3": config3}))
        for engine in RULE_CORES[:3]:
            path = os.path.join(tmp, f"words{OTHER_WORDS}.txt")
            with open(path, "wb") as fh:
                fh.write(b"\n".join(words3[:OTHER_WORDS]) + b"\n")
            plant = rule_gens[55].candidate(rule_gens[55].index_of(
                OTHER_WORDS - 1, RULE_8OPS))
            smoke.crack_words(
                cli, engine, path, OTHER_WORDS,
                smoke.get_engine(engine).hash_batch([plant])[0], plant)

    # 10. the rule kernel's time at 2^24 candidates a launch
    phase(10)
    say(f"== rule kernel timing at {RULE_BATCH} words x {N_RULES} rules "
        f"(CUDA events, {TIMED_LAUNCHES} launches); card: {card}")
    lengths = {ml: opcount.rule_lengths(
        *(a[:OTHER_WORDS] for a in rule_gens[ml].packed_words()), best64,
        ml) for ml in (27, 55)}
    for engine in RULE_CORES:
        max_len = 27 if engine == "ntlm" else 55
        counts = {n: c * RULE_BATCH // OTHER_WORDS
                  for n, c in lengths[max_len].items()}
        miss = digest_words(engine, smoke.get_engine(engine)
                            .hash_batch([b"\0" * 9])[0])
        padded, plain, *rest = rule_tables[max_len]
        tail = (0, RULE_BATCH, miss, 64, RULE_BATCH)
        ms = smoke.time_launches(
            lambda: cuda_rules.rules_kernel(engine, padded, *rest, *tail,
                                            max_len=max_len), ())
        plain_ms = smoke.time_once(cuda_rules.rules_plain,
                                   (engine, plain, *rest, *tail))
        work = opcount.rules_ops(engine, counts)
        ops_ms = work.slots / rate_ops * 1e3
        bytes_ = RULE_BATCH * (max_len + 4)
        bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        timing[rname(engine)] = (ms, plain_ms, bound,
                                 "operations" if ops_ms >= bytes_ms
                                 else "bytes")
        n = RULE_BATCH * N_RULES
        say(f"  {rname(engine)}: {ms:.4f} ms/launch = {n / ms / 1e6:.3f} G "
            f"candidates/s; bound {bound:.4f} ms (operations "
            f"{ops_ms:.4f} ms: per candidate {work.alu / n:.1f} ALU, "
            f"{work.add / n:.1f} IADD3, {work.fma / n:.1f} IMAD = "
            f"{work.slots / n:.1f} slots over lengths {lengths[max_len]} "
            f"(x {RULE_BATCH // OTHER_WORDS}); bytes {bytes_ms:.4f} ms: "
            f"the word table once, {bytes_} B, though the kernel reads "
            f"its rows padded to {cuda_rules.row_bytes(max_len)} B; kernel "
            f"at {bound / ms:.1%} of it); plain version {plain_ms:.3f} ms")

    # 11. the PMKID kernel vs its plain version
    phase(11)
    say(f"== PMKID kernel vs plain at {PMKID_CHECK_ITERS} iterations over "
        f"{PMKID_CHECK_BATCH} lanes (exact equality of the hit set)")
    g5 = MaskGenerator(MASK_CONFIG5)
    lut5 = g5.charset_lut("cuda")
    it = PMKID_CHECK_ITERS
    B5 = PMKID_CHECK_BATCH
    s5 = int(rng.integers(0, g5.keyspace // B5 - 4)) * B5
    other = (bytes(rng.integers(0, 256, 6, dtype=np.uint8)),
             bytes(rng.integers(0, 256, 6, dtype=np.uint8)))
    smoke.pmkid_case(g5, lut5, s5, B5, ESSID5, smoke.pmkid_targets(
        ESSID5, [(g5.candidate(s5), AP5, STA5)], it), [(0, 0)],
        "hit at lane 0")
    nv = B5 - 1000
    smoke.pmkid_case(g5, lut5, s5 + B5, nv, ESSID5, smoke.pmkid_targets(
        ESSID5, [(g5.candidate(s5 + B5 + nv - 1), AP5, STA5),
                 (g5.candidate(s5 + B5 + nv), *other)], it),
        [(nv - 1, 0)], f"hit at the last valid lane, n_valid={nv}")
    lane = int(rng.integers(0, B5))
    plain = g5.candidate(s5 + lane)
    smoke.pmkid_case(g5, lut5, s5, B5, ESSID5, smoke.pmkid_targets(
        ESSID5, [(b"not-in-the-mask", AP5, STA5), (plain, AP5, STA5),
                 (plain, *other)], it), [(lane, 1), (lane, 2)],
        "two targets of one ESSID hit by one lane")
    for essid in (b"benchnet-5g", b"x" * 32):
        lane = int(rng.integers(0, B5))
        smoke.pmkid_case(g5, lut5, s5 + 2 * B5, B5, essid,
                         smoke.pmkid_targets(essid, [(g5.candidate(
                             s5 + 2 * B5 + lane), *other)], it),
                         [(lane, 0)], f"ESSID {essid!r}")
    smoke.pmkid_case(g5, lut5, s5 + 3 * B5, B5, ESSID5, smoke.pmkid_targets(
        ESSID5, [(g5.candidate(s5), AP5, STA5)], it), [], "no hit")
    # the worker's overflow contract: count 1 > capacity 0 -> rescan
    plant = s5 + 4 * B5 + 777
    target = smoke.pmkid_targets(ESSID5, [(g5.candidate(plant), AP5,
                                           STA5)], it)
    iterations = Pmkid2Engine.iterations
    Pmkid2Engine.iterations = it
    try:
        eng = smoke.get_engine("wpa2-pmkid", "cuda")
        w = eng.make_mask_worker(g5, target, batch=B5, hit_capacity=0,
                                 oracle=smoke.get_engine("wpa2-pmkid"))
        hits = w.process(WorkUnit(0, plant - 100, 4096))
    finally:
        Pmkid2Engine.iterations = iterations
    check([(h.target_index, h.cand_index, h.plaintext) for h in hits]
          == [(0, plant, g5.candidate(plant))],
          f"pmkid hit_capacity=0 worker rescan returned {hits}")
    say(f"  pmkid worker rescan with hit_capacity=0 found "
        f"{hits[0].plaintext!r} at {plant}")
    # 4096 iterations, 2^20 lanes: three lanes planted by hashlib
    B20 = 1 << 20
    s20 = int(rng.integers(0, g5.keyspace // B20 - 1)) * B20
    lanes = [0, int(rng.integers(1, B20 - 1)), B20 - 1]
    smoke.pmkid_case(g5, lut5, s20, B20, ESSID5, smoke.pmkid_targets(
        ESSID5, [(g5.candidate(s20 + x), AP5, bytes([i]) * 6)
                 for i, x in enumerate(lanes)], 4096),
        [(x, i) for i, x in enumerate(lanes)],
        f"4096 iterations, {B20} lanes, lanes {lanes} planted by hashlib",
        iters=4096, batch=B20, plain=False)

    # 12. config 5 at full width through the CLI
    phase(12)
    say(f"== config 5: crack --device cuda --engine wpa2-pmkid "
        f"{MASK_CONFIG5} at 4096 iterations, a window of {CONFIG5_WINDOW} "
        f"candidates; card: {card}")
    skip = int(rng.integers(0, g5.keyspace - CONFIG5_WINDOW))
    plain = g5.candidate(skip + CONFIG5_WINDOW - 1)
    line = pmkid_line(plain, ESSID5, AP5, STA5, 4096)
    from dprf_tpu_torch.engines.device.pmkid import BATCH as PMKID_BATCH
    unit = cli.UNIT_BATCHES * PMKID_BATCH
    want_batches = sum(-(-min(unit, CONFIG5_WINDOW - u) // PMKID_BATCH)
                       for u in range(0, CONFIG5_WINDOW, unit))
    summary, wall5, launches = smoke.crack_lines(
        cli, "wpa2-pmkid", ["--skip", str(skip), "--limit",
                            str(CONFIG5_WINDOW), MASK_CONFIG5],
        [fake_pmkid_line(), line], [f"{line}:{plain.decode()}"],
        CONFIG5_WINDOW, (cuda_mask, cuda_rules, cuda_pbkdf2, cuda_bcrypt))
    check(launches["pmkid"] == want_batches == sum(launches.values())
          and f" batches={want_batches}" in summary,
          f"config 5: launches {launches}, {want_batches} batches")
    smoke.path_launches["pmkid"] = launches["pmkid"]
    rate5 = int(re.search(r" rate=([\d,]+)/s", summary).group(1)
                .replace(",", ""))
    say(f"  config 5: {wall5:.3f} s wall, loop {rate5} candidates/s, "
        f"{want_batches} launches of {PMKID_BATCH}; card: {card}")

    # 13. the bcrypt kernels vs their plain version, then vs the oracle
    phase(13)
    B4 = wave
    say(f"== bcrypt kernels vs plain on one wave of {B4} candidates "
        "(exact equality of P, S, digest words and hits)")
    lens4 = rng.integers(1, 73, B4)
    cand = np.zeros((B4, 72), np.uint8)
    for i, n in enumerate(lens4):
        cand[i, :n] = rng.integers(1, 256, n, dtype=np.uint8)
    hit, n_valid = 17, B4 - 5
    for dup in (B4 // 2, n_valid, 40):         # a twin, past n_valid, masked
        cand[dup], lens4[dup] = cand[hit], lens4[hit]
    valid = torch.ones(B4, dtype=torch.bool, device="cuda")
    valid[40] = False
    key = blowfish.key_words_from_candidates(
        torch.as_tensor(cand, device="cuda"),
        torch.as_tensor(lens4.astype(np.int32), device="cuda"))
    salt = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    sw = blowfish.salt_to_words(salt)
    s18 = blowfish.salt18_words(sw)
    Pk, Sk = cuda_bcrypt.setup_kernel(key, sw)
    P1, S1 = Pk.clone(), Sk.clone()
    cuda_bcrypt.advance_kernel(Pk, Sk, key, s18, 1)
    _, _, kd = cuda_bcrypt.finish_kernel(Pk, Sk, None, B4, np.zeros(6), 0)
    tgt = blowfish.digest_to_words(blowfish.words_to_digests(
        kd[hit:hit + 1].cpu().numpy())[0])
    kc, kl, kd = cuda_bcrypt.finish_kernel(Pk, Sk, valid, n_valid, tgt, 64)
    def diff(a, b) -> int:
        """Largest |a - b| over int32 words read as uint32."""
        return int(((a.long() & 0xFFFFFFFF) - (b.long() & 0xFFFFFFFF))
                   .abs().max().item())

    t0 = time.perf_counter()
    Pp, Sp = cuda_bcrypt.setup_plain(key, sw)
    smoke.err["bcrypt_setup"] = max(diff(Pp, P1), diff(Sp, S1))
    Pp, Sp = cuda_bcrypt.advance_plain(Pp, Sp, key, s18, 1)
    smoke.err["bcrypt_advance"] = max(diff(Pp, Pk), diff(Sp, Sk))
    pc, pl, pd = cuda_bcrypt.finish_plain(Pp, Sp, valid, n_valid, tgt, 64)
    kh = (int(kc.item()), sorted(x for x in kl.tolist() if x >= 0))
    ph = (int(pc.item()), sorted(x for x in pl.tolist() if x >= 0))
    smoke.err["bcrypt_finish"] = max(
        [diff(kd, pd), abs(kh[0] - ph[0])]
        + [abs(a - b) for a, b in zip(kh[1], ph[1])])
    say(f"  setup + advance(1) + finish: largest |kernel - plain| of P and "
        f"S {smoke.err['bcrypt_setup']} after setup, "
        f"{smoke.err['bcrypt_advance']} after advance; digest words and "
        f"hits {smoke.err['bcrypt_finish']}; kernel hits {kh} | plain hits "
        f"{ph} (plain chain {time.perf_counter() - t0:.1f} s)")
    check(smoke.err["bcrypt_setup"] == 0, "bcrypt_setup: kernel != plain")
    check(smoke.err["bcrypt_advance"] == 0,
          "bcrypt_advance: kernel != plain")
    check(smoke.err["bcrypt_finish"] == 0 and kh == (2, [hit, B4 // 2]),
          f"bcrypt_finish: kernel {kh} != plain {ph} or the planted lanes")
    # a partial last block: 17 whole blocks, then one of 45 candidates
    # (two whole warps, one of 13, the last warp empty), a twin of the
    # hit in its last lane (lane 40's twin, masked above, counts here)
    Bp = 17 * cuda_bcrypt.BLOCK + 45
    candp, lensp = cand[:Bp].copy(), lens4[:Bp].copy()
    candp[Bp - 1], lensp[Bp - 1] = cand[hit], lens4[hit]
    keyp = blowfish.key_words_from_candidates(
        torch.as_tensor(candp, device="cuda"),
        torch.as_tensor(lensp.astype(np.int32), device="cuda"))
    Pk, Sk = cuda_bcrypt.setup_kernel(keyp, sw)
    cuda_bcrypt.advance_kernel(Pk, Sk, keyp, s18, 1)
    kc, kl, kd = cuda_bcrypt.finish_kernel(Pk, Sk, None, Bp, tgt, 64)
    Pp, Sp = cuda_bcrypt.setup_plain(keyp, sw)
    Pp, Sp = cuda_bcrypt.advance_plain(Pp, Sp, keyp, s18, 1)
    pc, pl, pd = cuda_bcrypt.finish_plain(Pp, Sp, None, Bp, tgt, 64)
    kh = (int(kc.item()), sorted(x for x in kl.tolist() if x >= 0))
    ph = (int(pc.item()), sorted(x for x in pl.tolist() if x >= 0))
    errp = max(diff(Pp, Pk), diff(Sp, Sk), diff(kd, pd),
               abs(kh[0] - ph[0]))
    say(f"  a partial last block ({Bp} candidates, its last block of 45): "
        f"largest |kernel - plain| of P, S and the digest words {errp}; "
        f"kernel hits {kh} | plain hits {ph}")
    check(errp == 0 and kh == ph == (3, [hit, 40, Bp - 1]),
          f"bcrypt at {Bp} candidates: kernel {kh} != plain {ph} or the "
          "planted lanes")
    beng = smoke.get_engine("bcrypt", "cuda")
    oracle_b = smoke.get_engine("bcrypt")
    for password, line in OPENBSD:
        t = oracle_b.parse_target(line)
        got = beng.hash_batch([password], params=t.params)[0]
        check(got == t.digest, f"OpenBSD vector {line}: kernels disagree")
    for cost in (4, 5):
        salt = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
        words = [bytes(rng.integers(32, 127, int(n), dtype=np.uint8))
                 for n in (0, 1, 8, 71, 72)]
        got = beng.hash_batch(words, params={"salt": salt, "cost": cost})
        check(got == [bcrypt_raw(w, salt, cost) for w in words],
              f"bcrypt cost {cost}: the kernels' chain and the oracle "
              "differ")
    say("  the kernels' whole chain equals the oracle at cost 4 and 5 "
        "(lengths 0, 1, 8, 71, 72) and on the OpenBSD $2a$05 vectors")

    # 14. config 4 at full width through the CLI
    phase(14)
    say(f"== config 4: crack --device cuda --engine bcrypt -a wordlist, "
        f"{CONFIG4_WORDS} words at cost {CONFIG4_COST}; card: {card}")
    config4 = {}
    with tempfile.TemporaryDirectory() as tmp:
        path4 = os.path.join(tmp, "words.txt")
        with open(path4, "wb") as fh:
            fh.write(b"\n".join(words4) + b"\n")
        t0 = time.perf_counter()
        out4, _ = oracle4.communicate(timeout=600)
        line4 = out4.strip()
        check(oracle4.returncode == 0 and line4.startswith("$2b$12$"),
              f"the oracle's target line: {out4!r}")
        say(f"  planted line from the oracle ({time.perf_counter() - t0:.1f}"
            f" s more wait): {line4}")
        for name4, line, want in (
                ("sweep", fake_bcrypt_line(CONFIG4_COST), []),
                ("planted", line4, [f"{line4}:{words4[-1].decode()}"])):
            summary, wall, launches = smoke.crack_lines(
                cli, "bcrypt", ["-a", "wordlist", path4], [line], want,
                CONFIG4_WORDS, (cuda_mask, cuda_rules, cuda_pbkdf2,
                                cuda_bcrypt))
            batches = int(re.search(r" batches=(\d+)", summary).group(1))
            rounds = cuda_bcrypt.advanced_rounds
            check(batches == -(-CONFIG4_WORDS // wave)
                  and launches["bcrypt_setup"] == batches
                  and launches["bcrypt_finish"] == batches
                  and launches["bcrypt_advance"] >= batches
                  and rounds == batches << CONFIG4_COST
                  and launches["pmkid"] == 0
                  and sum(launches.values()) == 2 * batches
                  + launches["bcrypt_advance"],
                  f"config 4 {name4}: launches {launches}, {rounds} rounds "
                  f"for {batches} batches")
            config4[name4] = {"wall_s": wall, "launches": launches,
                              "rounds": rounds}
            if name4 == "sweep":
                for k in cuda_bcrypt.KERNELS:
                    smoke.path_launches[k] = launches[k]
    # the mask worker: ?l^3 at cost 4, targets at the first index and at
    # the last (the last valid lane of a partial batch)
    lines_m = [bcrypt_hash(p, bytes(range(16)), 4) for p in (b"aaa", b"zzz")]
    _, wall, launches = smoke.crack_lines(
        cli, "bcrypt", ["?l?l?l"], lines_m,
        [f"{lines_m[0]}:aaa", f"{lines_m[1]}:zzz"], 26 ** 3,
        (cuda_mask, cuda_rules, cuda_pbkdf2, cuda_bcrypt))
    batches = 2 * -(-26 ** 3 // wave)
    rounds = cuda_bcrypt.advanced_rounds
    check(launches["bcrypt_setup"] == launches["bcrypt_finish"] == batches
          and rounds == batches << 4
          and sum(launches.values()) == 2 * batches
          + launches["bcrypt_advance"],
          f"bcrypt mask: launches {launches}, {rounds} rounds for "
          f"{batches} batches")
    config4["mask_cost4"] = {"wall_s": wall, "launches": launches,
                             "rounds": rounds}
    say(json.dumps({"config4": config4}))

    # 15. timing of the PMKID and bcrypt kernels
    phase(15)
    say(f"== PMKID and bcrypt kernel timing (CUDA events); card: {card}")
    from dprf_tpu_torch.ops.cuda_pbkdf2 import target_table
    t5 = target_table(smoke.pmkid_targets(ESSID5, [(b"-", AP5, STA5)],
                                          4096), "cuda")
    args = (lut5, g5.radices, g5.digits(s5), PMKID_BATCH, ESSID5, 4096, t5,
            64, PMKID_BATCH)
    ms = smoke.time_launches(cuda_pbkdf2.pmkid_kernel, args, n=3, warm=1)
    work = opcount.pmkid_ops(g5.length, 4096)
    comps = sum(opcount.pmkid_compressions(4096).values())
    bound = PMKID_BATCH * work.slots / rate_ops * 1e3
    small = (lut5, g5.radices, g5.digits(s5), B5, ESSID5, it, t5, 64, B5)
    ms16 = smoke.time_launches(cuda_pbkdf2.pmkid_kernel, small, n=5)
    plain_ms = smoke.time_once(cuda_pbkdf2.pmkid_plain, small)
    timing["pmkid"] = (ms, plain_ms, bound, "operations", {
        "plain_input": f"{B5} lanes at {it} iterations (ms: {PMKID_BATCH} "
                       "at 4096)", "ms_at_plain_input": ms16})
    say(f"  pmkid: {ms:.2f} ms per launch of {PMKID_BATCH} at 4096 "
        f"iterations = {PMKID_BATCH / ms * 1e3:,.0f} candidates/s = "
        f"{PMKID_BATCH * comps / ms / 1e6:.3f} G SHA-1 compressions/s "
        f"({comps} a candidate); bound {bound:.2f} ms ({work.slots:,.0f} "
        f"slots a candidate: {work.alu:,.0f} ALU, {work.add:,.0f} IADD3); "
        f"kernel at {bound / ms:.1%} of it.  At {it} iterations over {B5} "
        f"lanes: kernel {ms16:.3f} ms, plain version {plain_ms:.1f} ms")
    wk = cand.shape[0]
    P, S = cuda_bcrypt.setup_kernel(key, sw)
    n_adv = 16
    ms_set = smoke.time_launches(cuda_bcrypt.setup_kernel, (key, sw), n=5,
                                 warm=1)
    ms_adv = smoke.time_launches(cuda_bcrypt.advance_kernel,
                                 (P, S, key, s18, n_adv), n=3, warm=1)
    ms_fin = smoke.time_launches(cuda_bcrypt.finish_kernel,
                                 (P, S, None, wk, tgt, 64), n=5, warm=1)
    P2, S2 = cuda_bcrypt.setup_plain(key, sw)
    plain_set = smoke.time_once(cuda_bcrypt.setup_plain, (key, sw),
                                warm=False)
    plain_adv = smoke.time_once(cuda_bcrypt.advance_plain,
                                (P2, S2, key, s18, 1), warm=False)
    plain_fin = smoke.time_once(cuda_bcrypt.finish_plain,
                                (P2, S2, None, wk, tgt, 64), warm=False)
    per_round = ms_adv / n_adv
    per_cand12 = (ms_set + per_round * (1 << CONFIG4_COST) + ms_fin) / wk
    tps = wave // sms
    BLOCK4 = cuda_bcrypt.BLOCK
    # the cost loop at the parent's wave and at this one, the SM clock
    # sampled while it runs: per candidate-round, per Feistel round
    adv_waves = {}
    for n_c in (PARENT_BCRYPT_WAVE, wk):
        kw = key[:n_c].contiguous()
        Pw, Sw = cuda_bcrypt.setup_kernel(kw, sw)
        ms_w, mhz = smoke.time_clocked(cuda_bcrypt.advance_kernel,
                                       (Pw, Sw, kw, s18, n_adv), seconds=0.6,
                                       chunk=4)
        cost_round = ms_w / n_adv
        adv_waves[n_c] = {
            "ms": ms_w, "sm_mhz": mhz, "ms_per_cost_round": cost_round,
            "ps_per_candidate_round": cost_round / n_c * 1e9,
            "cycles_per_feistel_round": cost_round * 1e-3 * mhz * 1e6
            / FEISTEL_PER_COST_ROUND,
            "cycles_per_feistel_round_at_max_clock": cost_round * 1e-3
            * clock_mhz * 1e6 / FEISTEL_PER_COST_ROUND}
        parent = PARENT_MS["bcrypt_advance"] / n_adv
        say(f"  bcrypt_advance at {n_c} candidates ({-(-n_c // BLOCK4)} "
            f"blocks of {BLOCK4}, {tps} chains an SM in a full wave): "
            f"{ms_w:.3f} ms per "
            f"launch of {n_adv} cost rounds = {cost_round:.4f} ms a cost "
            f"round = {cost_round / n_c * 1e9:,.1f} ps per candidate-round "
            f"(parent at {PARENT_BCRYPT_WAVE}: {parent:.4f} ms, "
            f"{parent / PARENT_BCRYPT_WAVE * 1e9:,.1f} ps); "
            f"{adv_waves[n_c]['cycles_per_feistel_round']:.2f} cycles a "
            f"Feistel round at the sampled {mhz:.0f} MHz "
            f"({adv_waves[n_c]['cycles_per_feistel_round_at_max_clock']:.2f}"
            f" at {clock_mhz:.0f}; opcount assumes "
            f"{opcount.BCRYPT_ROUND_LATENCY})")
    for k, ms_k, plain_k, rounds, moved in (
            ("bcrypt_setup", ms_set, plain_set,
             opcount.bcrypt_rounds(setup=True), 72 * 2 + 4096),
            ("bcrypt_advance", ms_adv, plain_adv,
             opcount.bcrypt_rounds(n_adv), 72 * 3 + 4096 * 2),
            ("bcrypt_finish", ms_fin, plain_fin,
             opcount.bcrypt_rounds(finish=True), 72 + 4096 + 24)):
        lim = opcount.bcrypt_bound(wk, rounds, sms, clock_mhz * 1e6, tps)
        ops_ms = max(lim["shared"], lim["issue"]) * 1e3
        bytes_ms = wk * moved / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        limit = "bytes" if bytes_ms > ops_ms else max(
            ("shared", "issue"), key=lim.get)
        timing[k] = (ms_k, plain_k, bound,
                     "operations" if ops_ms >= bytes_ms else "bytes",
                     {"bound_limit": limit} | ({
                         "plain_input": f"one round (ms: {n_adv} rounds)",
                         "waves": adv_waves}
                         if k == "bcrypt_advance" else {})
                     | clock_keys(bound, adv_waves[wk]["sm_mhz"], clock_mhz)
                     | {"wave": wk})
        say(f"  {k}: {ms_k:.3f} ms per launch of {wk} candidates "
            f"(parent {PARENT_MS[k]:.3f} ms at {PARENT_BCRYPT_WAVE}) "
            f"({rounds} Feistel rounds each); bound {bound:.3f} ms (shared "
            f"reads {lim['shared'] * 1e3:.3f} ms, issue slots "
            f"{lim['issue'] * 1e3:.3f} ms, bytes {bytes_ms:.4f} ms; kernel "
            f"at {bound / ms_k:.1%} of it); the dependent-latency limit at "
            f"{tps} threads an SM: {lim['latency'] * 1e3:.3f} ms; plain "
            f"version {plain_k:.1f} ms"
            + (" (one round)" if k == "bcrypt_advance" else ""))
    say(f"  bcrypt: {per_round:.4f} ms per cost round of a {wk}-candidate "
        f"wave = {per_round / wk * 1e6:.3f} ns per candidate-round; cost "
        f"{CONFIG4_COST}: {1e3 / per_cand12:,.1f} candidates/s")
    say(json.dumps({"slice_e_timing": {
        "pmkid_ms": ms, "pmkid_batch": PMKID_BATCH, "pmkid_16it_ms": ms16,
        "pmkid_plain_16it_ms": plain_ms, "bcrypt_wave": wk,
        "bcrypt_setup_ms": ms_set, "bcrypt_advance16_ms": ms_adv,
        "bcrypt_finish_ms": ms_fin, "bcrypt_cost12_per_s": 1e3 / per_cand12,
        "config5_wall_s": wall5, "config5_rate": rate5}}))

    ext_timing = slice_d(smoke, cli, card, rate_ops, g6, lut6, g7, lut7)
    f1_timing = slice_f1(smoke, cli, card, rate_ops, g6, lut6, g7, lut7)
    f2_timing = slice_f2(smoke, cli, card, rate_ops, clock_mhz, sms)
    f3_timing = slice_f3(smoke, cli, card, clock_mhz, sms)
    g_timing = slice_g(smoke, cli, card, rate_ops, g6, lut6, g7, lut7)
    l_timing = slice_l(smoke, cli, card, rate_ops, g6, lut6, g7, lut7)
    m_timing_rows = slice_m(smoke, cli, card, rate_ops, g6, lut6, g7, lut7)
    n_timing_rows = slice_n(smoke, cli, card, rate_ops, sms)
    o_timing_rows = slice_o(smoke, cli, card, rate_ops)

    # 51. the kernels line, then the device line
    kernels = []
    for engine, multi in INSTANCES:
        key = kname(engine, multi)
        ms, plain_ms, bound, more = timing[key]
        kernels.append({
            "name": key, "route": "cuda", "source": cuda_mask.SOURCE,
            "replaces": cuda_mask.REPLACES,
            "launches": smoke.path_launches[key],
            "max_abs_err": smoke.err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations",
            "library_ms": None, **more})
    for engine in RULE_CORES:
        key = rname(engine)
        ms, plain_ms, bound, bound_by = timing[key]
        kernels.append({
            "name": key, "route": "cuda", "source": cuda_rules.SOURCE,
            "replaces": cuda_rules.REPLACES,
            "launches": smoke.path_launches[key],
            "max_abs_err": smoke.err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None})
    for key, source, replaces in (
            ("pmkid", cuda_pbkdf2.SOURCE, cuda_pbkdf2.REPLACES),
            *((k, cuda_bcrypt.SOURCE, cuda_bcrypt.REPLACES)
              for k in cuda_bcrypt.KERNELS)):
        ms, plain_ms, bound, bound_by, more = timing[key]
        kernels.append({
            "name": key, "route": "cuda", "source": source,
            "replaces": replaces, "launches": smoke.path_launches[key],
            "max_abs_err": smoke.err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            **more})
    for chain, multi in EXT_INSTANCES:
        key = ename(chain, multi)
        ms, plain_ms, bound, more = ext_timing[key]
        kernels.append({
            "name": key, "route": "cuda", "source": cuda_ext.SOURCE,
            "replaces": cuda_ext.replaces(chain),
            "launches": smoke.path_launches[key],
            "max_abs_err": smoke.err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations",
            "library_ms": None, **more})
    for key, engine, _ in F1_INSTANCES:
        ms, plain_ms, bound, more = f1_timing[key]
        mod = cuda_keccak if key.startswith("keccak") else cuda_mask
        kernels.append({
            "name": key, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": smoke.path_launches[key],
            "max_abs_err": smoke.err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations",
            "library_ms": None, **more})
    for key, source, replaces in (
            ("krb5_group", cuda_krb5.SOURCE, cuda_krb5.REPLACES),
            ("pbkdf2_kdf", cuda_pbkdf2.SOURCE, cuda_pbkdf2.KDF_REPLACES)):
        ms, plain_ms, bound, bound_by, more = f2_timing[key]
        kernels.append({
            "name": key, "route": "cuda", "source": source,
            "replaces": replaces, "launches": smoke.path_launches[key],
            "max_abs_err": smoke.err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            **more})
    for key, source, replaces in (
            ("sevenzip_kdf", cuda_7z.SOURCE, cuda_7z.REPLACES),
            ("pdf", cuda_pdf.SOURCE, cuda_pdf.REPLACES)):
        ms, plain_ms, bound, bound_by, more = f3_timing[key]
        kernels.append({
            "name": key, "route": "cuda", "source": source,
            "replaces": replaces, "launches": smoke.path_launches[key],
            "max_abs_err": smoke.err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            **more})
    for engine in PROBE_CORES:
        key = kname(engine, PROBE)
        ms, plain_ms, bound, more = g_timing[key]
        kernels.append({
            "name": key, "route": "cuda", "source": cuda_mask.SOURCE,
            "replaces": cuda_mask.REPLACES,
            "launches": smoke.path_launches[key],
            "max_abs_err": smoke.err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations",
            "library_ms": None, **more})
    for key, _, _ in L_MASK:
        ms, plain_ms, bound, more = l_timing[key]
        kernels.append({
            "name": key, "route": "cuda", "source": cuda_mask.SOURCE,
            "replaces": cuda_mask.REPLACES,
            "launches": smoke.path_launches[key],
            "max_abs_err": smoke.err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations",
            "library_ms": None, **more})
    for variant, _ in L_SALTED:
        key = f"{variant}_group"
        ms, plain_ms, bound, more = l_timing[key]
        kernels.append({
            "name": key, "route": "cuda", "source": cuda_ext.SOURCE,
            "replaces": cuda_ext.replaces(variant),
            "launches": smoke.path_launches[key],
            "max_abs_err": smoke.err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations",
            "library_ms": None, **more})
    for key in M_KERNELS:
        ms, plain_ms, bound, bound_by, more = m_timing_rows[key]
        mod = cuda_mask if "_mask_" in key else cuda_rules
        kernels.append({
            "name": key, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": smoke.path_launches[key],
            "max_abs_err": smoke.err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            **more})
    for key in N_KERNELS:
        ms, plain_ms, bound, bound_by, more = n_timing_rows[key]
        core = key.split("_rules")[0]
        kernels.append({
            "name": key, "route": "cuda",
            "source": cuda_rules.SOURCE_FILES[cuda_rules.source_of(core)],
            "replaces": cuda_rules.replaces(core),
            "launches": smoke.path_launches[key],
            "max_abs_err": smoke.err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            **more})
    for key in O_KERNELS:
        ms, plain_ms, bound, bound_by, more = o_timing_rows[key]
        core = key.split("_rules")[0]
        kernels.append({
            "name": key, "route": "cuda",
            "source": cuda_rules.SOURCE_FILES[cuda_rules.source_of(core)],
            "replaces": cuda_rules.replaces(core),
            "launches": smoke.path_launches[key],
            "max_abs_err": smoke.err[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            **more})
    check(all(k["launches"] > 0 for k in kernels)
          and all(r["launches"] > 0 for r in
                  f3_timing["pdf"][4]["instantiations"].values()),
          "a kernel was not launched on its path")
    check(all(k["max_abs_err"] == 0 for k in kernels),
          "a kernel differs from its plain version")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))


def build_all(smoke, sms) -> None:
    """Phase 2: every source built with its own nvcc, all at once; each
    instantiation's registers, spills and SASS census printed and held
    to its pin; the occupancy of the main instantiations.  The registers
    go to smoke.registers."""
    from concurrent.futures import ThreadPoolExecutor

    from dprf_tpu_torch.ops import (_build, bloom, cuda_bcrypt, cuda_ext,
                                    cuda_krb5, cuda_mask, cuda_pbkdf2,
                                    cuda_rules)
    sources = ("mask", "rules", "rules_nested", "rules_group", "rules_wide",
               "pbkdf2", "bcrypt", "ext", "keccak", "krb5", "sevenzip", "pdf")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = {src: pool.submit(_build.build, src) for src in sources}
        builds = {src: f.result() for src, f in builds.items()}
    for mod in kernel_modules():
        mod.load_kernel()
    say(f"== build: {len(sources)} sources in "
        f"{time.perf_counter() - t0:.2f} s wall")
    registers = smoke.registers = {}
    for src, built in builds.items():
        say(f"  {built.path}: {built.seconds:.2f} s of nvcc")
        kernel = None
        for line in built.log.splitlines():
            if "Compiling entry function" in line:
                kernel = instance_of(line)
                say(f"  {kernel}:")
            elif "ptxas info    : Used" in line or "spill" in line:
                say("    " + line.strip())
                used = re.search(r"Used (\d+) registers", line)
                if used and kernel:
                    registers[kernel] = int(used.group(1))
                frame = re.search(r"(\d+) bytes stack frame", line)
                check(not frame or frame.group(1) == "0" or kernel not in
                      {ename(n, m) for n, m in EXT_INSTANCES}
                      | {k for k, _, _ in F1_INSTANCES}
                      | {kname(e, PROBE) for e in PROBE_CORES}
                      | {rname(e) for e in RULE_CORES}
                      | {"krb5_group", "pbkdf2_kdf", "sevenzip_kdf",
                         "pdf_r2_40", "pdf_r3_40", "pdf_r3_128"}
                      | set(L_KERNELS) | set(M_KERNELS) | set(N_KERNELS)
                      | set(O_KERNELS),
                      f"{kernel}: {line.strip()} (local memory)")
        census = _build.sass_census(src)
        for func, c in sorted(census.items(),
                              key=lambda kv: instance_of(kv[0])):
            top = ", ".join(f"{op} {n}" for op, n in c["by_opcode"].items())
            inst = instance_of(func)
            was = CENSUS_K3.get(inst)
            now = (registers.get(inst), c["total"])
            same = "" if was is None else (
                "; the slice K3 pin: "
                + ("same" if was == now else f"DIFFER, pinned {was}"))
            check(was is None or same.endswith("same"), f"{inst}{same}")
            if src in ("mask", "ext", "keccak", "bcrypt") and \
                    inst not in GROUPED_KERNELS and inst not in L_KERNELS \
                    and inst not in M_KERNELS:
                pin = CENSUS_K2.get(inst)
                same = "; the slice K2 pin: " + (
                    "same" if pin == now else f"DIFFER, pinned {pin}")
                check(same.endswith("same"), f"{inst}{same}")
            if inst in PDF_BEFORE:
                same = "; registers and census before the grouped krb5: " + (
                    "same" if PDF_BEFORE[inst] == now
                    else f"DIFFER, it had {PDF_BEFORE[inst]}")
                check(same.endswith("same"), f"{inst}{same}")
            if inst in GROUPED_KERNELS:
                pin = CENSUS_GROUPED[inst]
                same = "; the grouped kernel's pin: " + (
                    "same" if pin == now else f"DIFFER, pinned {pin}")
                check(same.endswith("same"), f"{inst}{same}")
            if inst in L_KERNELS:
                pin = CENSUS_L.get(inst)
                same = "; the slice L pin: " + (
                    "same" if pin == now else f"DIFFER, pinned {pin}")
                check(same.endswith("same"), f"{inst}{same}")
            if inst in M_KERNELS:
                pin = CENSUS_M.get(inst)
                same = "; the slice M pin: " + (
                    "same" if pin == now else f"DIFFER, pinned {pin}")
                check(same.endswith("same"), f"{inst}{same}")
            if inst in N_KERNELS:
                pin = CENSUS_N.get(inst)
                same = "; the slice N pin: " + (
                    "same" if pin == now else f"DIFFER, pinned {pin}")
                check(same.endswith("same"), f"{inst}{same}")
            if inst in O_KERNELS:
                pin = CENSUS_O.get(inst)
                same = "; the slice O pin: " + (
                    "same" if pin == now else f"DIFFER, pinned {pin}")
                check(same.endswith("same"), f"{inst}{same}")
            if inst == "pmkid":
                same = "; registers and census before the KDF kernel: " + (
                    "same" if PMKID_BEFORE == (registers.get(inst),
                                               c["total"])
                    else f"DIFFER, it had {PMKID_BEFORE}")
                check(same.endswith("same"), f"pmkid{same}")
            say(f"  SASS {inst}: {c['total']} static instructions, "
                f"{registers.get(inst)} registers{same} ({top})")
    for engine, multi in INSTANCES:
        length = 6 if engine == "md5" and not multi else 7
        n_sets = bloom.n_sets(N_TARGETS) if multi else 0
        smem = cuda_mask.shared_bytes(length, n_sets)
        say(f"  {kname(engine, multi)}: {smem} B shared at {length} "
            f"positions{' and 1,000 targets' if multi else ''}, "
            f"{cuda_mask.blocks_per_sm(engine, multi, smem)} resident "
            f"blocks of {cuda_mask.THREADS} per SM (the grid's wave)")
    smem = cuda_mask.shared_bytes(55, bloom.n_sets(bloom.MAX_TARGETS))
    say(f"  md5_mask_multi at its largest, 55 positions and "
        f"{bloom.MAX_TARGETS} targets: {smem} B shared, "
        f"{cuda_mask.blocks_per_sm('md5', True, smem)} resident blocks per "
        "SM")
    for engine in RULE_CORES:
        blocks = cuda_rules.blocks_per_sm(engine)
        say(f"  {rname(engine)}: {cuda_rules.shared_bytes(engine)} B shared, "
            f"{blocks} resident blocks of {cuda_rules.THREADS} per SM; "
            f"2^24 candidates a launch in runs of "
            f"{cuda_rules.rule_runs(RULE_BATCH, N_RULES, sms * blocks)} "
            "rules")

    for variant, _ in L_SALTED:
        smem = cuda_ext.salted_shared_bytes(variant, 6,
                                            cuda_ext.SALTED_GROUP)
        say(f"  {variant}_group: {smem} B shared at 6 positions and "
            f"{cuda_ext.SALTED_GROUP} targets, "
            f"{cuda_ext.salted_blocks_per_sm(variant, smem)} resident blocks "
            f"of {cuda_mask.THREADS} per SM (the grid's wave)")
    for chain, multi in EXT_INSTANCES:
        if chain in cuda_ext.SALTED_NAMES:
            smem = cuda_ext.salted_shared_bytes(chain, 6,
                                                cuda_ext.SALTED_GROUP)
            say(f"  {ename(chain, multi)}: {smem} B shared at 6 positions "
                f"and {cuda_ext.SALTED_GROUP} targets, "
                f"{cuda_ext.salted_blocks_per_sm(chain, smem)} resident "
                f"blocks of {cuda_mask.THREADS} per SM (the grid's wave)")
            continue
        n_sets = bloom.n_sets(N_TARGETS) if multi else 0
        smem = cuda_mask.shared_bytes(7, n_sets)
        say(f"  {kname(chain, multi)}: {smem} B shared at 7 "
            f"positions{' and 1,000 targets' if multi else ''}, "
            f"{cuda_ext.blocks_per_sm(chain, multi, smem)} resident blocks "
            f"of {cuda_mask.THREADS} per SM (the grid's wave)")
    smem = cuda_pbkdf2.shared_bytes(8)
    for k in (cuda_pbkdf2.KERNEL, cuda_pbkdf2.KDF_KERNEL):
        say(f"  {k}: {smem} B shared at 8 positions, "
            f"{cuda_pbkdf2.blocks_per_sm(smem, k)} resident blocks of "
            f"{cuda_pbkdf2.THREADS} per SM (the grid's wave)")
    smem = cuda_krb5.shared_bytes(8, cuda_krb5.GROUP)
    say(f"  krb5_group: {smem} B shared at 8 positions and "
        f"{cuda_krb5.GROUP} tickets (the RC4 states, the rows and the "
        f"tables; the opt-in above 48 KB), {cuda_krb5.blocks_per_sm(smem)} "
        f"resident blocks of {cuda_krb5.THREADS} per SM (the grid's wave)")
    for k in cuda_bcrypt.KERNELS:
        blocks, smem = cuda_bcrypt.occupancy(0, k)
        say(f"  {k}: {smem} B shared (the opt-in above 48 KB took), "
            f"{blocks} resident blocks of {cuda_bcrypt.BLOCK} candidates "
            f"({'/'.join(map(str, cuda_bcrypt.WARPS))} a warp) per SM")
    wave = cuda_bcrypt.resident_batch("cuda")
    say(f"  bcrypt: {wave} candidates a wave ({sms} SMs)")


def carry_start(rng, gen, lane: int) -> int:
    """A batch start whose lane ``lane`` is the first of a period of the
    last position in which position L - 2 wraps to 0 too (its carry goes
    into L - 3): the candidate there has digits ..., d, 0, 0 with d > 0,
    from a random index of ``gen``'s keyspace."""
    digits = gen.digits(int.from_bytes(rng.bytes(32), "little")
                        % (gen.keyspace // 2) + lane)
    digits[-1] = digits[-2] = 0
    digits[-3] = max(1, digits[-3])
    index = 0
    for d, r in zip(digits, gen.radices):
        index = index * r + d
    return index - lane


def clock_keys(bound: float, mhz, clock_mhz: float) -> dict:
    """The kernels line's keys of a kernel timed with the SM clock
    sampled: the sampled clock (None where the phase sampled none) and
    the bound at that clock.  Both come from this run; the parent times
    (PARENT_MS) are printed in the phases' text only."""
    more = {"sm_mhz": mhz}
    if mhz:
        more["bound_ms_at_sm_mhz"] = bound * clock_mhz / mhz
    return more


def unit_windows(cli, window: int) -> int:
    """Loop-superstep windows the mask worker makes of a window of a
    core: one for each of the CLI's units (16 batches of 2^24, within
    max_inner's 127), the last one partial."""
    return -(-window // (cli.UNIT_BATCHES * BATCH))


def unit_batches(cli, window: int) -> int:
    """Batches of 2^24 the CLI's units make of a window."""
    unit = cli.UNIT_BATCHES * BATCH
    return sum(-(-min(unit, window - u) // BATCH)
               for u in range(0, window, unit))


def kernel_modules() -> tuple:
    """Every kernel wrapper module, whose launch counts a path reads."""
    from dprf_tpu_torch.ops import (cuda_7z, cuda_bcrypt, cuda_ext,
                                    cuda_keccak, cuda_krb5, cuda_mask,
                                    cuda_pbkdf2, cuda_pdf, cuda_rules)
    return (cuda_mask, cuda_rules, cuda_pbkdf2, cuda_bcrypt, cuda_ext,
            cuda_keccak, cuda_krb5, cuda_7z, cuda_pdf)


def run_path(smoke, cli, engine, mask, lines, want, window, key, n_launches,
             skip=0):
    """crack --device cuda over a window from ``skip`` with every launch
    count set to 0 just before it: only ``key`` may launch, ``n_launches``
    times (the worker's batches).  Returns (summary, wall s)."""
    argv = ["--skip", str(skip), "--limit", str(window)] if skip else []
    summary, wall, launches = smoke.crack_lines(
        cli, engine, [*argv, mask], lines, want, window, kernel_modules())
    batches = int(re.search(r" batches=(\d+)", summary).group(1))
    check(launches[key] == n_launches == batches
          and sum(launches.values()) == n_launches,
          f"{engine}: launches {launches}, {batches} batches, expected "
          f"{n_launches} of {key}")
    smoke.path_launches.setdefault(key, launches[key])
    return summary, wall


def loop_rate(summary: str) -> int:
    return int(re.search(r" rate=([\d,]+)/s", summary).group(1)
               .replace(",", ""))


def slice_d(smoke, cli, card, rate_ops, g6, lut6, g7, lut7) -> dict:
    """Phases 16-20: the nested chains and salted cores of csrc/ext.cu.
    Returns their timing rows (ms, plain ms, bound ms) by instantiation;
    their main paths' launches go to smoke.path_launches."""
    import numpy as np
    import torch

    from dprf_tpu_torch.ops import bloom, cuda_ext, cuda_mask, opcount
    from dprf_tpu_torch.runtime.potfile import encode_plain

    rng = smoke.rng

    def alnum(n: int) -> bytes:
        return bytes(rng.choice(np.frombuffer(ALNUM, np.uint8), n))

    def path(*args, **kwargs):
        return run_path(smoke, cli, *args, **kwargs)

    # 16. the ext kernel vs its plain version
    phase(16)
    say(f"== 16. ext kernel (csrc/ext.cu) vs plain at batch {BATCH} (exact "
        "equality)")
    base = int(rng.integers(0, g7.keyspace // BATCH - 2)) * BATCH
    nv = BATCH - 1000
    single = (cuda_ext.nested_kernel, cuda_ext.nested_plain)
    multi = (cuda_ext.nested_multi_kernel, cuda_ext.nested_multi_plain)
    for name in cuda_ext.NESTED_NAMES:
        smoke.single_case(name, g7, lut7, base, BATCH, base, 64, [0],
                          "?a^7 hit at lane 0", single)
        smoke.single_case(name, g7, lut7, base + BATCH, nv,
                          base + BATCH + nv - 1, 64, [nv - 1],
                          f"?a^7 hit at last valid lane, n_valid={nv}",
                          single)
        smoke.single_case(name, g7, lut7, base, BATCH, None, 64, [],
                          "?a^7 no hit", single)
        smoke.multi_case(name, g7, lut7, base, nv,
                         [base, base + 64, base + 65, base + nv - 1,
                          base + nv], "?a^7 hits at lanes 0, 64, 65, "
                         f"n_valid-1 and n_valid={nv}", fns=multi)
        smoke.multi_case(name, g7, lut7, base + BATCH, BATCH, [base],
                         "?a^7 no hit", fns=multi)
    # the salted kernel: a target of every salt length 0..32, grouped as
    # the worker groups them (one ps group; 33 sp groups), one plant at
    # lane 0, at the last valid lane of a partial batch, at a random
    # lane and one just past the valid lanes
    s16 = 3 * BATCH
    for variant in cuda_ext.SALTED_NAMES:
        oracle = smoke.get_engine(variant)
        lanes_of = {0: 0, 32: nv - 1, 16: int(rng.integers(1, nv - 1)),
                    7: nv}
        targets, want = [], []
        for n in range(cuda_ext.SALT_MAX + 1):
            salt = bytes(rng.integers(0, 256, n, dtype=np.uint8))
            lane = lanes_of.get(n)
            plain = g6.candidate(s16 + lane) if lane is not None \
                else b"\0" * 7
            d = oracle.hash_batch([plain], params={"salt": salt})[0]
            if lane is not None and lane < nv:
                want.append((lane, n))
            targets.append((salt, digest_words(variant, d)))
        got = []
        for idx in cuda_ext.salted_groups(variant,
                                          [t[0] for t in targets]):
            rows, shift = cuda_ext.salted_table(
                variant, g6.length, [targets[i] for i in idx], "cuda")
            got += smoke.group_case(
                cuda_ext.salted_kernel, cuda_ext.salted_plain,
                (variant, lut6, g6.radices, g6.digits(s16), nv, shift, rows,
                 64, BATCH), idx, [w for w in want if w[1] in idx],
                f"{variant}_group",
                f"?l^6, {len(idx)} targets, salts of "
                f"{sorted({len(targets[i][0]) for i in idx})} bytes")
        check(sorted(got) == sorted(want), f"{variant}: hits {got}")
    # md5-ps at phase 18's group size: SALTED_GROUP targets with salts of
    # 0..32 bytes, the plants at target positions past 200 (lane 0, the
    # last valid lane, a random lane, two targets on one lane, one plant
    # just past the valid lanes) and one at position 0
    oracle = smoke.get_engine("md5-ps")
    n_group = cuda_ext.SALTED_GROUP
    rnd = int(rng.integers(1, nv - 1))
    lanes_of = {0: rnd, 201: 0, 230: nv - 1, 254: rnd, n_group - 1: nv - 1,
                240: nv, 222: int(rng.integers(1, nv - 1))}
    targets, want = [], []
    for i in range(n_group):
        salt = alnum(int(rng.integers(0, cuda_ext.SALT_MAX + 1)))
        lane = lanes_of.get(i)
        plain = g6.candidate(s16 + lane) if lane is not None \
            else b"\0" * 7
        d = oracle.hash_batch([plain], params={"salt": salt})[0]
        if lane is not None and lane < nv:
            want.append((lane, i))
        targets.append((salt, digest_words("md5-ps", d)))
    rows, shift = cuda_ext.salted_table("md5-ps", g6.length, targets, "cuda")
    count, lanes, tpos, _ = cuda_ext.salted_kernel(
        "md5-ps", lut6, g6.radices, g6.digits(s16), nv, shift, rows,
        64 * n_group, BATCH)
    pairs = sorted((int(a), int(b)) for a, b in zip(lanes.tolist(),
                                                    tpos.tolist()) if a >= 0)
    check(int(count.item()) == len(pairs) and pairs == sorted(want),
          f"md5-ps_group at {n_group} targets: hits {pairs}, expected "
          f"{sorted(want)}")
    # kernel == plain on the same launch over N_CHECK_TARGETS of the
    # group's targets, its planted ones among them (the plain version
    # runs the core a target at a time: 17.6 s for all 256)
    idx = sorted(set(lanes_of) | {1})[:N_CHECK_TARGETS]
    smoke.group_case(
        cuda_ext.salted_kernel, cuda_ext.salted_plain,
        ("md5-ps", lut6, g6.radices, g6.digits(s16), nv, shift, rows[idx],
         64 * len(idx), BATCH), idx, [w for w in want if w[1] in idx],
        "md5-ps_group", f"?l^6, a group of {n_group} targets (phase 18's), "
        f"salts of 0-32 bytes, plants at target positions "
        f"{sorted(lanes_of)}: the kernel's {len(pairs)} hits at "
        f"{n_group} targets the plants; kernel == plain over targets {idx}")
    # the worker's hit buffer: hit_capacity a target of the group.  Two
    # targets hit in one batch at a capacity of one: the group's buffer
    # holds both and nothing is rescanned; with a buffer of one slot the
    # worker rescans the target it did not record, alone
    from dprf_tpu_torch.engines.device.salted import CudaSaltedMaskWorker
    from dprf_tpu_torch.runtime.workunit import WorkUnit
    plants = [s16 + 5, s16 + 900]
    tl = [oracle.parse_target(f"{d.hex()}:{salt.decode()}") for d, salt in
          ((oracle.hash_batch([g6.candidate(p)],
                              params={"salt": salt})[0], salt)
           for p, salt in zip(plants, (b"ab", b"cdef")))]
    def one_slot(step):
        def narrow(base_digits, n_valid):
            count, lanes, tpos, tcount = step(base_digits, n_valid)
            return count, lanes[:1], tpos[:1], tcount
        return narrow

    for slots in (None, 1):
        w = CudaSaltedMaskWorker(smoke.get_engine("md5-ps", "cuda"), g6, tl,
                                 batch=BATCH, hit_capacity=1, oracle=oracle)
        if slots:
            w.groups = [(idx, one_slot(step)) for idx, step in w.groups]
        rescans = []
        rescan = w._rescan
        w._rescan = lambda tis, b, u: rescans.append(tis) or rescan(tis, b, u)
        hits = w.process(WorkUnit(0, s16, 4096))
        # the kernel records one of the two hits, whichever lands first
        check([(h.target_index, h.cand_index) for h in hits]
              == [(0, plants[0]), (1, plants[1])]
              and [len(r) for r in rescans] == ([1] if slots else []),
              f"salted group of 2, {slots or 2} slots: {hits}, rescans "
              f"{rescans}")
        say(f"  md5-ps group of 2, hit capacity 1, a buffer of "
            f"{slots or 2} slots: {len(hits)} hits, targets rescanned "
            f"{rescans}")

    # 17. nested at full width: config 2's shape for hashcat 2600
    phase(17)
    say(f"== 17. crack --device cuda --engine md5(md5) {MASK_CONFIG2}, "
        f"{N_TARGETS} targets, a window of {CONFIG2_WINDOW}; card: {card}")
    skip = int(rng.integers(0, g7.keyspace - CONFIG2_WINDOW))
    within = sorted({int(x) for x in rng.integers(1, CONFIG2_WINDOW - 1, 5)})
    b = within[0] // BATCH * BATCH
    idx = sorted({0, CONFIG2_WINDOW - 1, b + 100, b + 101, *within[1:]})
    check(len(idx) == 8, f"planted indices collide: {idx}")
    planted = [g7.candidate(skip + i) for i in idx]
    oracle = smoke.get_engine("md5(md5)")
    hits = oracle.hash_batch(planted)
    digests = hits + smoke.fillers("md5(md5)", N_TARGETS - 8)
    digests = [digests[i] for i in rng.permutation(N_TARGETS)]
    summary, wall2600 = path(
        "md5(md5)", MASK_CONFIG2, [d.hex() for d in digests],
        [f"{d.hex()}:{encode_plain(p)}" for d, p in zip(hits, planted)],
        CONFIG2_WINDOW, "md5(md5)_mask_multi",
        unit_batches(cli, CONFIG2_WINDOW), skip)
    rate2600 = loop_rate(summary)
    say(f"  md5(md5) at {N_TARGETS} targets: {wall2600:.3f} s wall, loop "
        f"{rate2600:,} candidates/s, planted at window offsets {idx}")
    plain = g6.candidate(g6.keyspace - 1)
    line = "*" + smoke.get_engine("mysql41").hash_batch([plain])[0].hex() \
        .upper()
    path("mysql41", MASK_CONFIG1, [line], [f"{line}:{plain.decode()}"],
         g6.keyspace, "mysql41_mask", unit_batches(cli, g6.keyspace))

    # 18. salted at full width: 1,000 targets, each its own salt
    phase(18)
    say(f"== 18. crack --device cuda --engine md5-ps {MASK_CONFIG1}, "
        f"{N_SALTED} targets with salts of 2-32 bytes, every target swept "
        f"in full; card: {card}")
    oracle = smoke.get_engine("md5-ps")
    lens = [32, 2] + [int(x) for x in rng.integers(2, 33, N_SALTED - 2)]
    salts = [alnum(n) for n in lens]
    idx = sorted({g6.keyspace - 1, *(int(x) for x in rng.integers(
        0, g6.keyspace - 1, 7))})
    check(len(idx) == 8, f"planted indices collide: {idx}")
    lines, want = [], []
    for i, salt in enumerate(salts):
        plain = g6.candidate(idx[i]) if i < 8 else \
            bytes(rng.integers(33, 127, 8, dtype=np.uint8))
        d = oracle.hash_batch([plain], params={"salt": salt})[0]
        lines.append(f"{d.hex()}:{salt.decode()}")
        if i < 8:
            want.append(f"{lines[-1]}:{plain.decode()}")
    per_group = unit_batches(cli, g6.keyspace)
    groups = cuda_ext.salted_groups("md5-ps", salts)
    path_group = {"md5-ps": max(len(g) for g in groups)}
    n_launch = per_group * len(groups)
    summary, wall_s = path("md5-ps", MASK_CONFIG1, lines, want, g6.keyspace,
                           "md5-ps_group", n_launch)
    rate_s = loop_rate(summary)
    loop_s = g6.keyspace / rate_s
    # the host's cost of one launch as the worker queues it (the step
    # and the device add of its hit flag), over launches of 1,024 lanes
    # the card finishes at once
    words = digest_words("md5-ps", oracle.hash_batch(
        [b"-"], params={"salt": salts[0]})[0])
    step = cuda_ext.make_salted_crack_step(
        "md5-ps", g6, [(salts[0], words)] * len(groups[0]), BATCH,
        64 * len(groups[0]), "cuda")
    n_host = 2000
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flag = None
    for _ in range(n_host):
        count = step(g6.digits(0), 1024)[0]
        flag = count if flag is None else flag + count
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / n_host * 1e6
    say(f"  md5-ps sweep: {wall_s:.3f} s wall, loop {loop_s:.3f} s = "
        f"{rate_s * N_SALTED:,} hashes/s ({rate_s:,} candidates/s x "
        f"{N_SALTED} targets), {n_launch} launches ({len(groups)} groups of "
        f"{[len(g) for g in groups]} targets x {per_group} batches) = "
        f"{loop_s / n_launch * 1e3:.4f} ms a launch of the loop; the host's "
        f"own time per launch {host_us:.1f} us; card: {card}")
    say(json.dumps({"salted_sweep": {
        "wall_s": wall_s, "loop_s": loop_s, "hashes_per_s": rate_s * N_SALTED,
        "launches": n_launch, "groups": [len(g) for g in groups],
        "host_us_per_launch": host_us,
        "targets": N_SALTED, "salt_lens": [min(lens), max(lens)]},
        "nested_1000": {"wall_s": wall2600, "rate": rate2600}}))
    for engine, salt in (("sha1-sp", alnum(16)), ("sha256-ps", alnum(32)),
                         ("md5-sp", alnum(2)), ("sha256-sp", alnum(8)),
                         ("postgres", b"postgres_admin"),
                         ("ldap-ssha", bytes(rng.integers(
                             0, 256, 8, dtype=np.uint8))),
                         ("oracle11", bytes(rng.integers(
                             0, 256, 10, dtype=np.uint8)))):
        plain = g6.candidate(g6.keyspace - 1)
        d = smoke.get_engine(engine).hash_batch([plain],
                                                params={"salt": salt})[0]
        if engine == "postgres":
            line = f"md5{d.hex()}:{salt.decode()}"
        elif engine == "ldap-ssha":
            import base64
            line = "{SSHA}" + base64.b64encode(d + salt).decode()
        elif engine == "oracle11":
            line = f"S:{d.hex().upper()}{salt.hex().upper()}"
        else:
            line = f"{d.hex()}:{salt.decode()}"
        variant = f"{smoke.get_engine(engine, 'cuda').algo}-" \
                  f"{smoke.get_engine(engine, 'cuda').order}"
        path(engine, MASK_CONFIG1, [line], [f"{line}:{plain.decode()}"],
             g6.keyspace, f"{variant}_group", unit_batches(cli, g6.keyspace))

    # 19. the other nested instantiations, each over 16 batches
    phase(19)
    say(f"== 19. the other nested instantiations: crack --device cuda over "
        f"{OTHER_WINDOW} candidates of {MASK_CONFIG2}")
    for name, multi_ in EXT_INSTANCES:
        key = kname(name, multi_)
        if "-" in name or key in smoke.path_launches:
            continue
        skip = int(rng.integers(0, g7.keyspace - OTHER_WINDOW))
        plain = g7.candidate(skip + int(rng.integers(0, OTHER_WINDOW)))
        oracle = smoke.get_engine(name)
        digests = oracle.hash_batch([plain])
        if multi_:
            digests += smoke.fillers(name, N_TARGETS - 1)
        lines = ["*" + d.hex().upper() if name == "mysql41" else d.hex()
                 for d in digests]
        path(name, MASK_CONFIG2, lines,
             [f"{lines[0]}:{encode_plain(plain)}"], OTHER_WINDOW, key,
             unit_batches(cli, OTHER_WINDOW), skip)

    # 20. timing at batch 2^24
    phase(20)
    say(f"== 20. ext kernel timing at batch 2^24 (CUDA events, "
        f"{TIMED_LAUNCHES} launches, the SM clock sampled over the phase); "
        f"card: {card}")
    timing = {}
    salt = alnum(TIMING_SALT)
    per_hash = {}
    with SmClock() as clock:
        for name, multi_ in EXT_INSTANCES:
            key = ename(name, multi_)
            gen, lut = (g6, lut6) if "-" in name else (g7, lut7)
            start = int(rng.integers(0, gen.keyspace // BATCH)) * BATCH
            head = (name, lut, gen.radices, gen.digits(start), BATCH)
            more = {}
            if "-" in name:
                miss = digest_words(name, smoke.get_engine(name).hash_batch(
                    [b"\0" * 9], params={"salt": salt})[0])

                def group_args(n_targets):
                    rows, shift = cuda_ext.salted_table(
                        name, gen.length, [(salt, miss)] * n_targets, "cuda")
                    return (*head, shift, rows, 64, BATCH)

                group = path_group.get(name, 1)
                args = group_args(group)
                fn, plain_fn = cuda_ext.salted_kernel, cuda_ext.salted_plain
                work = opcount.salted_ops(name, gen.length, salt, group)
                hashes = BATCH * group
                more = {"group": group}
                what = (f"{gen.mask}, a {TIMING_SALT}-byte salt, a group of "
                        f"{group} targets (its main path's)")
            elif multi_:
                _, rows, words = smoke.tables(name,
                                              smoke.fillers(name, N_TARGETS))
                args = (*head, rows, words, 64, BATCH)
                fn, plain_fn = cuda_ext.nested_multi_kernel, \
                    cuda_ext.nested_multi_plain
                n_maybe = int(fn(*args)[3].item())
                probes = bloom.expected_probes(rows.cpu().numpy()
                                               .view(np.uint32))
                work = opcount.nested_ops(
                    name, gen.length, True, probes, n_maybe / BATCH,
                    N_TARGETS, run=cuda_mask.lanes_a_run(name, gen.radices))
                hashes = BATCH
                what = f"{gen.mask}, {N_TARGETS} targets"
            else:
                miss = digest_words(name, smoke.get_engine(name).hash_batch(
                    [b"\0" * 9])[0])
                args = (*head, miss, 64, BATCH)
                fn, plain_fn = cuda_ext.nested_kernel, cuda_ext.nested_plain
                work = opcount.nested_ops(
                    name, gen.length,
                    run=cuda_mask.lanes_a_run(name, gen.radices))
                hashes = BATCH
                what = gen.mask
            ms = smoke.time_launches(fn, args)
            if more.get("group", 1) > N_CHECK_TARGETS:
                # the plain version runs the core a target at a time (17.6
                # s for md5-ps at 256): timed on N_CHECK_TARGETS targets of
                # the group, the kernel there too; phase 16 warmed it up
                sub = group_args(N_CHECK_TARGETS)
                plain_ms = smoke.time_once(plain_fn, sub, warm=False)
                more["plain_input"] = f"{N_CHECK_TARGETS} of the {group} " \
                    "targets"
                more["ms_at_plain_input"] = smoke.time_launches(fn, sub)
            else:
                plain_ms = smoke.time_once(plain_fn, args)
            bound = hashes * work.slots / rate_ops * 1e3
            timing[key] = (ms, plain_ms, bound, more)
            say(f"  {key} {what}: {ms:.4f} ms/launch = "
                f"{hashes / ms / 1e6:.3f} G hashes/s; bound {bound:.4f} ms "
                f"(per hash {work.alu:.1f} ALU, {work.add:.1f} IADD3, "
                f"{work.fma:.1f} IMAD = {work.slots:.1f} slots; kernel at "
                f"{bound / ms:.1%} of it); plain version {plain_ms:.3f} ms"
                + (f" ({more['plain_input']}, the kernel there "
                   f"{more['ms_at_plain_input']:.4f} ms)"
                   if "plain_input" in more else ""))
            if "-" in name:
                per_hash[name] = {}
                for t in sorted({1, cuda_ext.SALTED_GROUP, group}):
                    t_ms = ms if t == group else \
                        smoke.time_launches(fn, group_args(t), n=10)
                    w_t = opcount.salted_ops(name, gen.length, salt, t)
                    b_t = BATCH * t * w_t.slots / rate_ops * 1e3
                    per_hash[name][t] = {"ms_per_2e24_hashes": t_ms / t,
                                         "bound_per_2e24_hashes": b_t / t}
                    say(f"    {name} at a group of {t}: {t_ms:.4f} ms a "
                        f"launch = {t_ms / t:.4f} ms per 2^24 hashes "
                        f"(bound {b_t / t:.4f} ms, {b_t / t_ms:.1%})")
    say(f"  the SM clock over the phase: {clock.mhz} MHz (nvidia-smi, "
        f"{len(clock.samples)} samples); card: {card}")
    for key, (ms, _, bound, more) in timing.items():
        if key in PARENT_MS:
            more.update(clock_keys(bound, clock.mhz, smoke.clock_mhz))
            say(f"    {key}: {ms:.4f} ms, parent {PARENT_MS[key]:.4f} ms "
                f"(x{PARENT_MS[key] / ms:.3f}); kernel at "
                f"{more['bound_ms_at_sm_mhz'] / ms:.1%} of the bound at the "
                f"sampled clock")
    say(json.dumps({"salted_per_hash": per_hash, "card": card}))
    return timing


def f1_key(engine: str, multi: bool) -> str:
    """The instantiation an engine of slice F1 runs: sha3-N and keccak-N
    share keccakN's."""
    from dprf_tpu_torch.ops import cuda_keccak
    if engine in cuda_keccak.NAMES:
        return kname(f"keccak{cuda_keccak.bits_of(engine)}", multi)
    return kname(engine, multi)


def slice_f1(smoke, cli, card, rate_ops, g6, lut6, g7, lut7) -> dict:
    """Phases 21-23: sha512 and sha384 in csrc/mask.cu and the Keccak
    kernel of csrc/keccak.cu.  Returns their timing rows (ms, plain ms,
    bound ms) by instantiation; their main paths' launches go to
    smoke.path_launches."""
    import numpy as np

    from dprf_tpu_torch.generators.mask import MaskGenerator
    from dprf_tpu_torch.ops import bloom, cuda_keccak, cuda_mask, opcount
    from dprf_tpu_torch.runtime.potfile import encode_plain

    rng = smoke.rng

    def fns(key: str, multi: bool) -> tuple:
        if key.startswith("keccak"):
            return (cuda_keccak.keccak_mask_multi_kernel,
                    cuda_keccak.keccak_mask_multi_plain) if multi else \
                (cuda_keccak.keccak_mask_kernel, cuda_keccak.keccak_mask_plain)
        return (cuda_mask.mask_multi_kernel, cuda_mask.mask_multi_plain) \
            if multi else (cuda_mask.mask_kernel, cuda_mask.mask_plain)

    def longest(engine: str) -> int:
        return smoke.get_engine(engine, "cuda").max_candidate_len

    def occupancy(key: str, multi: bool, length: int, n_sets: int) -> int:
        smem = cuda_mask.shared_bytes(length, n_sets)
        if key.startswith("keccak"):
            return cuda_keccak.blocks_per_sm(int(key[6:9]), multi, smem)
        return cuda_mask.blocks_per_sm(key.split("_")[0], multi, smem)

    # 21. the kernels vs their plain versions
    phase(21)
    say(f"== 21. sha512/384 (csrc/mask.cu) and Keccak (csrc/keccak.cu) vs "
        f"plain at batch {BATCH} (exact equality)")
    base = int(rng.integers(0, g7.keyspace // BATCH - 2)) * BATCH
    nv = BATCH - 1000
    last = g6.keyspace // BATCH * BATCH
    for key, engine, multi in F1_INSTANCES:
        # keccak-N for half the cases: the other pad byte, the same
        # instantiation (sha512 and sha384 have one name)
        other = engine.replace("sha3-", "keccak-")
        pair = fns(key, multi)
        if not multi:
            say(f"  {key}: {occupancy(key, False, 7, 0)} resident blocks of "
                f"{cuda_mask.THREADS} per SM at 7 positions")
            smoke.single_case(engine, g7, lut7, base, BATCH, base, 64, [0],
                              "?a^7 hit at lane 0", pair, key=key)
            smoke.single_case(other, g6, lut6, last, g6.keyspace - last,
                              g6.keyspace - 1, 64, [g6.keyspace - last - 1],
                              "?l^6 hit at the last valid lane", pair,
                              key=key)
            smoke.single_case(engine, g7, lut7, base + BATCH, BATCH, None, 64,
                              [], "?a^7 no hit", pair, key=key)
            s = 11 * BATCH
            smoke.single_case(other, g6, lut6, s, BATCH, s + 12345, 0, [],
                              "?l^6 hit_capacity=0", pair, key=key)
            gl = MaskGenerator("?a" * 7 + "?d" * (longest(engine) - 7))
            s = int(rng.integers(0, 1 << 62)) * BATCH
            smoke.single_case(engine, gl, gl.charset_lut("cuda"), s,
                              BATCH - 7, s + BATCH - 8, 64, [BATCH - 8],
                              f"{gl.length} positions, hit at the last "
                              "valid lane", pair, key=key)
            continue
        smoke.multi_case(other, g7, lut7, base, nv,
                         [base, base + 64, base + 65, base + nv - 1,
                          base + nv], "?a^7 hits at lanes 0, 64, 65, "
                         f"n_valid-1 and n_valid={nv}", fns=pair, key=key)
        smoke.multi_case(engine, g7, lut7, base + BATCH, BATCH, [base],
                         "?a^7 no hit", fns=pair, key=key)
        gl = MaskGenerator("?a" * 7 + "?d" * (longest(engine) - 7))
        n_sets = bloom.n_sets(bloom.MAX_TARGETS)
        smem = cuda_mask.shared_bytes(gl.length, n_sets)
        s = int(rng.integers(0, 1 << 62)) * BATCH
        nvl = BATCH - 7
        smoke.multi_case(engine, gl, gl.charset_lut("cuda"), s, nvl,
                         [s, s + 1, s + nvl - 1],
                         f"{gl.length} positions at {bloom.MAX_TARGETS} "
                         f"targets ({smem} B shared, "
                         f"{occupancy(key, True, gl.length, n_sets)} resident "
                         f"blocks per SM), hits at lanes 0, 1 and "
                         f"n_valid-1={nvl - 1}", n_targets=bloom.MAX_TARGETS,
                         fns=pair, key=key)

    # 22. the slice end to end through the CLI
    phase(22)
    say(f"== 22. crack --device cuda: sha512, sha384, sha3-256, keccak-256 "
        f"over {MASK_CONFIG1} (one target) and a {CONFIG2_WINDOW} window of "
        f"{MASK_CONFIG2} ({N_TARGETS} targets); the other Keccak names over "
        f"{OTHER_WINDOW}; card: {card}")
    e2e = {}
    for engine in ("sha512", "sha384", "sha3-256", "keccak-256"):
        plain = g6.candidate(g6.keyspace - 1)
        line = smoke.get_engine(engine).hash_batch([plain])[0].hex()
        summary, wall = run_path(
            smoke, cli, engine, MASK_CONFIG1, [line],
            [f"{line}:{plain.decode()}"], g6.keyspace, f1_key(engine, False),
            unit_batches(cli, g6.keyspace))
        e2e[f"{engine} ?l^6"] = {"wall_s": wall, "rate": loop_rate(summary)}
        skip = int(rng.integers(0, g7.keyspace - CONFIG2_WINDOW))
        within = sorted({int(x) for x in rng.integers(1, CONFIG2_WINDOW - 1,
                                                      5)})
        b = within[0] // BATCH * BATCH
        idx = sorted({0, CONFIG2_WINDOW - 1, b + 100, b + 101, *within[1:]})
        check(len(idx) == 8, f"planted indices collide: {idx}")
        planted = [g7.candidate(skip + i) for i in idx]
        hits = smoke.get_engine(engine).hash_batch(planted)
        digests = hits + smoke.fillers(engine, N_TARGETS - 8)
        digests = [digests[i] for i in rng.permutation(N_TARGETS)]
        summary, wall = run_path(
            smoke, cli, engine, MASK_CONFIG2, [d.hex() for d in digests],
            [f"{d.hex()}:{encode_plain(p)}" for d, p in zip(hits, planted)],
            CONFIG2_WINDOW, f1_key(engine, True),
            unit_batches(cli, CONFIG2_WINDOW), skip)
        maybes = int(re.search(r"maybes=(\d+)", summary).group(1))
        e2e[f"{engine} ?a^7 x {N_TARGETS}"] = {
            "wall_s": wall, "rate": loop_rate(summary), "maybes": maybes}
        say(f"  {engine} at {N_TARGETS} targets over {CONFIG2_WINDOW}: "
            f"{wall:.3f} s wall, loop {loop_rate(summary):,} candidates/s, "
            f"maybes {maybes}, planted at window offsets {idx}")
    for engine in ("sha3-224", "sha3-384", "sha3-512", "keccak-224",
                   "keccak-384", "keccak-512"):
        multi = engine.startswith("keccak")
        skip = int(rng.integers(0, g7.keyspace - OTHER_WINDOW))
        plain = g7.candidate(skip + int(rng.integers(0, OTHER_WINDOW)))
        digests = smoke.get_engine(engine).hash_batch([plain])
        if multi:
            digests += smoke.fillers(engine, N_TARGETS - 1)
        summary, wall = run_path(
            smoke, cli, engine, MASK_CONFIG2, [d.hex() for d in digests],
            [f"{digests[0].hex()}:{encode_plain(plain)}"], OTHER_WINDOW,
            f1_key(engine, multi), unit_batches(cli, OTHER_WINDOW), skip)
        e2e[f"{engine} 2^28"] = {"wall_s": wall, "rate": loop_rate(summary)}

    # 23. timing at batch 2^24
    phase(23)
    say(f"== 23. slice F1 timing at batch 2^24 (CUDA events, "
        f"{TIMED_LAUNCHES} launches, the SM clock sampled over the phase); "
        f"card: {card}")
    timing = {}
    with SmClock() as clock:
        for key, engine, multi in F1_INSTANCES:
            fn, plain_fn = fns(key, multi)
            start = int(rng.integers(0, g7.keyspace // BATCH)) * BATCH
            head = (engine, lut7, g7.radices, g7.digits(start), BATCH)
            if multi:
                _, rows, words = smoke.tables(engine,
                                              smoke.fillers(engine, N_TARGETS))
                args = (*head, rows, words, 64, BATCH)
                n_maybe = int(fn(*args)[3].item())
                probes = bloom.expected_probes(rows.cpu().numpy()
                                               .view(np.uint32))
                work = opcount.ops_per_candidate(
                    engine, g7.length, True, probes, n_maybe / BATCH,
                    N_TARGETS)
                what = f"{g7.mask}, {N_TARGETS} targets"
            else:
                miss = digest_words(engine, smoke.get_engine(engine)
                                    .hash_batch([b"\0" * 9])[0])
                args = (*head, miss, 64, BATCH)
                work = opcount.ops_per_candidate(engine, g7.length)
                what = g7.mask
            ms = smoke.time_launches(fn, args)
            plain_ms = smoke.time_once(plain_fn, args, warm=False)
            bound = BATCH * work.slots / rate_ops * 1e3
            timing[key] = (ms, plain_ms, bound, {})
            say(f"  {key} ({engine}) {what}: {ms:.4f} ms/launch = "
                f"{BATCH / ms / 1e6:.3f} G candidates/s; bound {bound:.4f} ms "
                f"(per candidate {work.alu:.1f} ALU, {work.add:.1f} IADD3, "
                f"{work.fma:.1f} IMAD = {work.slots:.1f} slots; kernel at "
                f"{bound / ms:.1%} of it); plain version {plain_ms:.3f} ms")
    say(f"  the SM clock over the phase: {clock.mhz} MHz (nvidia-smi, "
        f"{len(clock.samples)} samples); card: {card}")
    for key, (ms, _, bound, more) in timing.items():
        more.update(clock_keys(bound, clock.mhz, smoke.clock_mhz))
        say(f"    {key}: {ms:.4f} ms, parent {PARENT_MS[key]:.4f} ms "
            f"(x{PARENT_MS[key] / ms:.3f}; one lane a thread, as the "
            f"parent); kernel at {more['bound_ms_at_sm_mhz'] / ms:.1%} of "
            "the bound at the sampled clock")
    say(json.dumps({"slice_f1": e2e}))
    return timing


def krb5_line(rng, password: bytes, asrep: bool, body_len: int,
              tag: int = None) -> str:
    """A valid etype-23 line by the port's oracle: RFC 4757 run forward
    over an 8-byte confounder and a DER ticket of ``body_len`` seeded
    content bytes, as a KDC makes one."""
    from dprf_tpu_torch.engines.cpu.krb5 import der, encrypt
    tag = tag if tag is not None else (0x79 if asrep else 0x63)
    body = bytes(rng.integers(0, 256, body_len, dtype="uint8"))
    plain = bytes(rng.integers(0, 256, 8, dtype="uint8")) + \
        der(tag, der(0x30, body))
    chk, edata = encrypt(password, 8 if asrep else 2, plain)
    if asrep:
        return f"$krb5asrep$23$user@CORP.LOCAL:{chk.hex()}${edata.hex()}"
    return (f"$krb5tgs$23$*svc$CORP.LOCAL$http/web*${chk.hex()}$"
            f"{edata.hex()}")


def aes_line(rng, tag: str, etype: int, usage: int, password: bytes,
             body_len: int, user: str, realm: str = "CORP.LOCAL") -> str:
    """A valid AES etype-17/18 line by the port's oracle: RFC 3962 run
    forward at KDF_ITERS iterations over a 16-byte confounder and a DER
    blob of ``body_len`` seeded content bytes."""
    from dprf_tpu_torch.engines.cpu.krb5 import der
    from dprf_tpu_torch.engines.cpu.krb5aes import encrypt
    app = {1: 0x30, 2: 0x63, 3: 0x79}[usage]
    body = bytes(rng.integers(0, 256, body_len, dtype="uint8"))
    plain = bytes(rng.integers(0, 256, 16, dtype="uint8")) + \
        der(app, der(0xA0 if usage == 1 else 0x30, body))
    chk, edata = encrypt(password, (realm + user).encode(),
                         16 if etype == 17 else 32, usage, plain, KDF_ITERS)
    return f"${tag}${etype}${user}${realm}${chk.hex()}${edata.hex()}"


def slice_f2(smoke, cli, card, rate_ops, clock_mhz, sms) -> dict:
    """Phases 24-27: the Kerberos RC4 kernel of csrc/krb5.cu and the KDF
    kernel of csrc/pbkdf2.cu.  Returns their timing rows (ms, plain ms,
    bound ms, bound_by); their main paths' launches go to
    smoke.path_launches."""
    import numpy as np
    import torch

    from dprf_tpu_torch.engines.device import krb5aes as dev_aes
    from dprf_tpu_torch.engines.device.krb5 import CudaKrb5MaskWorker
    from dprf_tpu_torch.ops.pack import words_to_bytes_be
    from dprf_tpu_torch.generators.mask import MaskGenerator
    from dprf_tpu_torch.ops import cuda_krb5, cuda_pbkdf2, opcount
    from dprf_tpu_torch.runtime.potfile import encode_plain
    from dprf_tpu_torch.runtime.workunit import WorkUnit

    rng = smoke.rng
    g8 = MaskGenerator(MASK_BENCH)
    lut8 = g8.charset_lut("cuda")
    gl8 = MaskGenerator(MASK_CONFIG5)
    lutl8 = gl8.charset_lut("cuda")

    def ticket(plain, asrep, body, tag=None):
        """(oracle, Target) of a ticket for ``plain``."""
        eng = smoke.get_engine("krb5asrep" if asrep else "krb5tgs")
        return eng, eng.parse_target(krb5_line(rng, plain, asrep, body, tag))

    # 24. the krb5 kernel vs its plain version
    phase(24)
    say(f"== 24. krb5 kernel (csrc/krb5.cu) vs plain at batch {BATCH}, "
        "tickets grouped by msg_type (exact equality of the count, the "
        "(lane, ticket) pairs and the per-ticket counts)")

    def case(gen, lut, start, n_valid, tickets, cap, planted, name,
             batch=BATCH):
        """The kernel and its plain version on each msg_type group of
        ``tickets`` ((oracle, Target) each): equal count, pairs and
        per-ticket counts; the planted (lane, ticket) pairs among them,
        and any other pair a false maybe of the prefilter (odds 2^-32 a
        candidate, 2^-30 for AS-REP), which the oracle rejects."""
        tgts = [cuda_krb5.target_kernel_args(t) for _, t in tickets]
        got = []
        for idx in cuda_krb5.krb5_groups(tgts):
            rows = torch.as_tensor(cuda_krb5.ticket_rows(
                [tgts[i] for i in idx]).view(np.int32), device="cuda")
            got += smoke.group_case(
                cuda_krb5.krb5_kernel, cuda_krb5.krb5_plain,
                (lut, gen.radices, gen.digits(start), n_valid,
                 tgts[idx[0]].msg_type, rows, cap, batch), idx, None,
                "krb5_group", f"{name}, msg_type {tgts[idx[0]].msg_type}, "
                f"{len(idx)} tickets")
        maybes = sorted(set(got) - set(planted))
        check((cap == 0 and not got) or (cap and set(planted) <= set(got)
              and not any(tickets[t][0].verify(gen.candidate(start + x),
                                               tickets[t][1])
                          for x, t in maybes)),
              f"krb5 {name}: {got}, planted {planted}")
        if maybes:
            say(f"    pairs {maybes} are false maybes the oracle rejects")

    base = int(rng.integers(0, g8.keyspace // BATCH - 2)) * BATCH
    nv = BATCH - 1000
    lane = int(rng.integers(0, nv))
    # TGS tickets of every DER length form and AS-REP tickets with the
    # 0x79 and the relaxed 0x7A tag, in one list: two groups
    spec = [(False, 1200, None, 0, "TGS 0x82 form"),
            (False, 60, None, nv - 1, "TGS short form"),
            (False, 180, None, None, "TGS 0x81 form"),
            (False, 70_000, None, lane, "TGS 0x83 form"),
            (True, 1200, None, BATCH // 3, "AS-REP 0x79 0x82 form"),
            (True, 300, 0x7A, 77, "AS-REP 0x7A"),
            (True, 250, None, nv, "AS-REP, a plant past the valid lanes")]
    tickets = [ticket(g8.candidate(base + p) if p is not None else b"-",
                      asrep, body, tag) for asrep, body, tag, p, _ in spec]
    planted = [(p, i) for i, (_, _, _, p, _) in enumerate(spec)
               if p is not None and p < nv]
    case(g8, lut8, base, nv, tickets, 64, planted,
         f"{len(spec)} tickets ({', '.join(x[4] for x in spec)}), hits at "
         f"lanes 0, {nv - 1} (the last valid), {lane}, {BATCH // 3}, 77, "
         f"n_valid={nv}")
    g27 = MaskGenerator("?a" * 7 + "?d" * 20)
    s27 = int(rng.integers(0, 1 << 62)) * BATCH
    case(g27, g27.charset_lut("cuda"), s27, BATCH - 5,
         [ticket(g27.candidate(s27 + BATCH - 6), False, 1200)], 64,
         [(BATCH - 6, 0)], f"the longest mask, 27 positions, lane "
         f"{BATCH - 6}")
    # the Kerberoast's group: 100 TGS tickets of 990-1,490-byte bodies,
    # the plants at ticket positions 0 and past 90 (lane 0, the last
    # valid lane, a random lane twice, one just past the valid lanes)
    nvg = KRB5_GROUP_LANES - 3
    rnd = int(rng.integers(1, nvg - 1))
    lanes_of = {0: rnd, 91: 0, 95: nvg - 1, 97: rnd, 98: nvg,
                KERBEROAST_TICKETS - 1: int(rng.integers(1, nvg - 1))}
    roast = [ticket(g8.candidate(base + lanes_of[i]) if i in lanes_of
                    else b"-", False, int(rng.integers(990, 1490)))
             for i in range(KERBEROAST_TICKETS)]
    case(g8, lut8, base, nvg, roast, 64 * KERBEROAST_TICKETS,
         [(p, i) for i, p in lanes_of.items() if p < nvg],
         f"the Kerberoast's group of {KERBEROAST_TICKETS} tickets at "
         f"{KRB5_GROUP_LANES} lanes, n_valid={nvg}, plants at ticket "
         f"positions {sorted(lanes_of)}", batch=KRB5_GROUP_LANES)
    plant = base + BATCH // 5
    case(g8, lut8, base, BATCH, [ticket(g8.candidate(plant), False, 60),
                                 ticket(g8.candidate(plant + 1), False, 61)],
         0, [(plant - base, 0), (plant + 1 - base, 1)], "hit capacity 0")
    eng = smoke.get_engine("krb5tgs")
    dev = smoke.get_engine("krb5tgs", "cuda")
    t = eng.parse_target(krb5_line(rng, g8.candidate(plant), False, 60))
    w = CudaKrb5MaskWorker(dev, g8, [t], batch=BATCH, hit_capacity=0,
                           oracle=eng)
    hits = w.process(WorkUnit(0, plant - 100, 4096))
    check([(h.cand_index, h.plaintext) for h in hits]
          == [(plant, g8.candidate(plant))],
          f"krb5 hit_capacity=0 worker rescan returned {hits}")
    say(f"  krb5 worker rescan with hit_capacity=0 found "
        f"{hits[0].plaintext!r} at {plant}")

    # 25. the KDF kernel vs its plain version at the main path's batch,
    # then hashlib
    phase(25)
    b19 = dev_aes.BATCH
    nv19 = b19 - 3
    say(f"== 25. pbkdf2_kdf (csrc/pbkdf2.cu) vs plain at {KDF_CHECK_ITERS} "
        f"iterations over {nv19} valid lanes of a batch of {b19}, the main "
        f"path's (exact equality of every word), then hashlib at "
        f"{KDF_ITERS}")
    s19 = int(rng.integers(0, gl8.keyspace // b19)) * b19
    kdf_plain_ms = {}
    for n_words in (4, 8):
        for salt in (b"R", KDF_TIMING_SALT, b"S" * 51):
            args = (lutl8, gl8.radices, gl8.digits(s19), nv19, salt,
                    KDF_CHECK_ITERS, n_words, b19)
            k = cuda_pbkdf2.kdf_kernel(*args)
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            p = cuda_pbkdf2.kdf_plain(*args)
            t1.record()
            torch.cuda.synchronize()
            if salt == KDF_TIMING_SALT:
                kdf_plain_ms[n_words] = t0.elapsed_time(t1)
            err = int((k.long() - p.long()).abs().max().item())
            smoke.err["pbkdf2_kdf"] = max(smoke.err["pbkdf2_kdf"], err)
            say(f"  pbkdf2_kdf n_words={n_words} salt of {len(salt)} B: "
                f"{tuple(k.shape)} words, max |kernel - plain| = {err}; "
                f"plain {t0.elapsed_time(t1):.1f} ms")
            check(err == 0 and k.shape == (nv19, n_words),
                  "pbkdf2_kdf: kernel and plain differ")
    b20 = KDF_HASHLIB_LANES
    s20 = int(rng.integers(0, gl8.keyspace // b20)) * b20
    salt = b"CORP.LOCALsvc_backup"
    lanes = [0, int(rng.integers(1, b20 - 1)), b20 - 1]
    for n_words in (8, 4):
        k = cuda_pbkdf2.kdf_kernel(lutl8, gl8.radices, gl8.digits(s20), b20,
                                   salt, KDF_ITERS, n_words, b20)
        k = k.cpu().numpy()
        for x in lanes:
            want = hashlib.pbkdf2_hmac("sha1", gl8.candidate(s20 + x), salt,
                                       KDF_ITERS, 4 * n_words)
            check(k[x].view(np.uint32).astype(">u4").tobytes() == want,
                  f"pbkdf2_kdf lane {x}: kernel and hashlib differ")
    say(f"  pbkdf2_kdf at {KDF_ITERS} iterations over {b20} lanes: lanes "
        f"{lanes} equal hashlib.pbkdf2_hmac at 16 and 32 bytes")

    # 26. the slice end to end through the CLI
    phase(26)
    window = KRB5_WINDOW
    say(f"== 26. crack --device cuda: the Kerberoast (krb5tgs, "
        f"{KERBEROAST_TICKETS} tickets of 1,000-1,500 bytes, 4 planted) and "
        f"AS-REP roast (krb5asrep, {ASREP_TICKETS}, 1 planted) over {window} "
        f"of {MASK_BENCH}; krb5tgs-aes etype 18 (4 tickets, 1 planted) over "
        f"{AES18_WINDOW} and krb5asrep17 over {AES17_WINDOW} of "
        f"{MASK_CONFIG5} at {KDF_ITERS} iterations; card: {card}")
    e2e = {}

    def roast(engine, n_targets, n_planted, asrep, p_false):
        skip = int(rng.integers(0, g8.keyspace - window))
        idx = sorted({window - 1, *(int(x) for x in rng.integers(
            0, window - 1, n_planted - 1))})
        check(len(idx) == n_planted, f"planted indices collide: {idx}")
        planted = [g8.candidate(skip + i) for i in idx]
        lines = [krb5_line(rng, p, asrep, int(rng.integers(990, 1490)))
                 for p in planted]
        lines += [krb5_line(rng, b"no-such-password%d" % i, asrep,
                            int(rng.integers(990, 1490)))
                  for i in range(n_targets - n_planted)]
        order = rng.permutation(n_targets)
        want = [f"{ln}:{encode_plain(p)}" for ln, p in zip(lines, planted)]
        n_groups = -(-n_targets // cuda_krb5.GROUP)
        summary, wall = run_path(
            smoke, cli, engine, MASK_BENCH, [lines[i] for i in order], want,
            window, "krb5_group", n_groups * unit_batches(cli, window), skip)
        maybes = int(re.search(r"maybes=(\d+)", summary).group(1))
        predicted = p_false * window * n_targets
        check(maybes <= max(20, 4 * predicted),
              f"{engine}: {maybes} maybes, predicted {predicted:.2f}")
        e2e[engine] = {"wall_s": wall, "rate": loop_rate(summary),
                       "maybes": maybes, "maybes_predicted": predicted,
                       "planted_at": idx, "skip": skip,
                       "launches": n_groups * unit_batches(cli, window)}
        say(f"  {engine}: {wall:.3f} s wall, {n_targets} tickets x {window} "
            f"candidates, loop {loop_rate(summary):,} candidates/s "
            f"(x tickets), maybes {maybes} (predicted {predicted:.2f})")

    roast("krb5tgs", KERBEROAST_TICKETS, 4, False, 2.0 ** -32)
    roast("krb5asrep", ASREP_TICKETS, 1, True, 2.0 ** -30)

    def aes_run(engine, tag, etype, usage, n_targets, win):
        skip = int(rng.integers(0, gl8.keyspace - win))
        plain = gl8.candidate(skip + win - 1)
        lines = [aes_line(rng, tag, etype, usage, plain,
                          int(rng.integers(990, 1490)), "svc_sql01")]
        lines += [aes_line(rng, tag, etype, usage, b"no-such-password%d" % i,
                           int(rng.integers(990, 1490)), f"svc_app{i}")
                  for i in range(n_targets - 1)]
        check(smoke.get_engine(engine).iterations == KDF_ITERS,
              f"{engine}: {smoke.get_engine(engine).iterations} iterations")
        batch = dev_aes.BATCH
        unit = cli.UNIT_BATCHES * batch
        batches = sum(-(-min(unit, win - u) // batch)
                      for u in range(0, win, unit))
        summary, wall = run_path(
            smoke, cli, engine, MASK_CONFIG5, lines,
            [f"{lines[0]}:{plain.decode()}"], win, "pbkdf2_kdf",
            n_targets * batches, skip)
        e2e[f"{engine} etype {etype}"] = {
            "wall_s": wall, "rate": loop_rate(summary),
            "maybes": int(re.search(r"maybes=(\d+)", summary).group(1)),
            "launches": n_targets * batches}
        say(f"  {engine} etype {etype}: {wall:.3f} s wall, {n_targets} "
            f"tickets x {win} candidates, loop {loop_rate(summary):,} "
            f"candidates/s (x tickets)")

    aes_run("krb5tgs-aes", "krb5tgs", 18, 2, 4, AES18_WINDOW)
    aes_run("krb5asrep17", "krb5asrep", 17, 3, 1, AES17_WINDOW)
    # a Pre-Auth timestamp under 64 bytes is refused on the card
    short = aes_line(rng, "krb5pa", 18, 1, b"x", 20, "user")
    with tempfile.TemporaryDirectory() as tmp:
        hashfile = os.path.join(tmp, "pa.txt")
        with open(hashfile, "w") as fh:
            fh.write(short + "\n")
        err = io.StringIO()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(err):
            rc = cli.main(["crack", "--device", "cuda", "--engine", "krb5pa",
                           "?d?d?d", hashfile, "--no-potfile"])
    check(rc == 2 and "--device cpu" in err.getvalue()
          and "line 1" in err.getvalue(),
          f"krb5pa under 64 bytes: exit {rc}, {err.getvalue()[-500:]}")
    say(f"  krb5pa with a {len(bytes.fromhex(short.rsplit('$', 1)[1]))}-byte"
        f" edata2 exits {rc}: {err.getvalue().strip().splitlines()[-1]}")
    say(json.dumps({"slice_f2": e2e}))

    # 27. timing
    phase(27)
    say(f"== 27. slice F2 timing (CUDA events); card: {card}")
    timing = {}
    start = int(rng.integers(0, g8.keyspace // BATCH)) * BATCH
    tgt = cuda_krb5.target_kernel_args(ticket(b"\0" * 9, False, 1200)[1])

    def group_args(n_tickets):
        rows = torch.as_tensor(cuda_krb5.ticket_rows(
            [tgt] * n_tickets).view(np.int32), device="cuda")
        return (lut8, g8.radices, g8.digits(start), BATCH, tgt.msg_type,
                rows, 64, BATCH)

    # the Kerberoast's group; the plain version on one ticket
    args = group_args(KERBEROAST_TICKETS)
    ms = smoke.time_launches(cuda_krb5.krb5_kernel, args, n=5, warm=1)
    ms1 = smoke.time_launches(cuda_krb5.krb5_kernel, group_args(1))
    plain_ms = smoke.time_once(cuda_krb5.krb5_plain, group_args(1),
                               warm=False)
    lim = opcount.krb5_bound(BATCH, g8.length, sms, clock_mhz * 1e6,
                             KERBEROAST_TICKETS)
    lim1 = opcount.krb5_bound(BATCH, g8.length, sms, clock_mhz * 1e6)
    work = opcount.krb5_ops(g8.length, KERBEROAST_TICKETS)
    bound = max(lim.values()) * 1e3
    bound1 = max(lim1.values()) * 1e3
    per_pair = ms / KERBEROAST_TICKETS
    timing["krb5_group"] = (ms, plain_ms, bound, "operations", {
        "bound_limit": max(lim, key=lim.get), "group": KERBEROAST_TICKETS,
        "plain_input": f"one ticket (ms: {KERBEROAST_TICKETS})",
        "ms_at_plain_input": ms1})
    smem = cuda_krb5.shared_bytes(g8.length, KERBEROAST_TICKETS)
    say(f"  krb5_group {MASK_BENCH}, {KERBEROAST_TICKETS} tickets: {ms:.4f} "
        f"ms per launch of {BATCH} candidates = {per_pair:.4f} ms per 2^24 "
        f"(candidate, ticket) pairs = "
        f"{BATCH * KERBEROAST_TICKETS / ms / 1e6:.3f} G pairs/s; bound "
        f"{bound:.4f} ms (issue {lim['issue'] * 1e3:.4f} ms at "
        f"{work.slots:.1f} slots a pair: {work.alu:.1f} ALU, {work.add:.1f} "
        f"IADD3, {work.fma:.1f} IMAD; shared {lim['shared'] * 1e3:.4f} ms at "
        f"{opcount.RC4_SHARED} accesses a pair); kernel at {bound / ms:.1%} "
        f"of it; {smem} B shared, {cuda_krb5.blocks_per_sm(smem)} resident "
        f"blocks per SM.  One ticket a launch: {ms1:.4f} ms (bound "
        f"{bound1:.4f} ms, {bound1 / ms1:.1%}); plain version "
        f"{plain_ms:.1f} ms (one ticket)")
    rows = {}
    for n_words in (8, 4):
        args = (lutl8, gl8.radices, gl8.digits(s19), b19, KDF_TIMING_SALT,
                KDF_ITERS, n_words, b19)
        ms_k = smoke.time_launches(cuda_pbkdf2.kdf_kernel, args, n=3, warm=1)
        work = opcount.kdf_ops(gl8.length, KDF_ITERS, n_words)
        bound = b19 * work.slots / rate_ops * 1e3
        # the kernel on phase 25's input, which the plain version timed
        small = (lutl8, gl8.radices, gl8.digits(s19), nv19, KDF_TIMING_SALT,
                 KDF_CHECK_ITERS, n_words, b19)
        ms16 = smoke.time_launches(cuda_pbkdf2.kdf_kernel, small, n=5)
        plain16 = kdf_plain_ms[n_words]
        comps = sum(opcount.kdf_compressions(KDF_ITERS, n_words).values())
        rows[n_words] = (ms_k, plain16, bound, "operations", {
            "plain_input": f"{nv19} lanes at {KDF_CHECK_ITERS} iterations "
                           f"(ms: {b19} at {KDF_ITERS})",
            "ms_at_plain_input": ms16})
        say(f"  pbkdf2_kdf n_words={n_words} (etype "
            f"{18 if n_words == 8 else 17}): {ms_k:.2f} ms per launch of "
            f"{b19} at {KDF_ITERS} iterations = {b19 / ms_k * 1e3:,.0f} "
            f"candidates/s = {b19 * comps / ms_k / 1e6:.3f} G SHA-1 "
            f"compressions/s ({comps} a candidate); bound {bound:.2f} ms "
            f"({work.slots:,.0f} slots a candidate); kernel at "
            f"{bound / ms_k:.1%} of it.  At {KDF_CHECK_ITERS} iterations over "
            f"{nv19} lanes: kernel {ms16:.3f} ms, plain version "
            f"{plain16:.1f} ms")
    timing["pbkdf2_kdf"] = rows[8]

    # one etype-18 step of the main path, and its torch verdict alone
    params = smoke.get_engine("krb5tgs-aes").parse_target(aes_line(
        rng, "krb5tgs", 18, 2, b"-", 1200, "svc_sql01")).params
    step = dev_aes.make_kdf_step(gl8, b19, params, 64, KDF_ITERS, "cuda")
    check_fn = dev_aes.make_krb5aes_check(params)
    expected = dev_aes.expected_word(params)
    words = cuda_pbkdf2.kdf_kernel(lutl8, gl8.radices, gl8.digits(s19), b19,
                                   params["salt"], KDF_ITERS, 8, b19)

    def verdict(w):
        return check_fn(words_to_bytes_be(w))[:, 0] == expected

    verdict_ms = smoke.time_launches(verdict, (words,), n=5, warm=1)
    step_ms = smoke.time_launches(step, (gl8.digits(s19), b19), n=3, warm=1)
    say(f"  etype-18 step of {b19}: {step_ms:.2f} ms; the KDF kernel "
        f"{rows[8][0]:.2f} ms; the torch verdict alone (two DK derivations, "
        f"one AES block decrypted, the masked compare) {verdict_ms:.2f} ms "
        f"= {verdict_ms / step_ms:.1%} of the step; the rest of the step "
        f"outside the kernel {step_ms - rows[8][0]:.2f} ms")
    say(json.dumps({"slice_f2_timing": {
        "krb5_group_ms": timing["krb5_group"][0],
        "krb5_group_tickets": KERBEROAST_TICKETS,
        "krb5_ms_per_2e24_pairs": per_pair, "krb5_one_ticket_ms": ms1,
        "krb5_plain_ms": timing["krb5_group"][1],
        "krb5_bound_ms": timing["krb5_group"][2],
        "kdf18_ms": rows[8][0], "kdf17_ms": rows[4][0],
        "kdf18_bound_ms": rows[8][2], "kdf17_bound_ms": rows[4][2],
        "kdf18_plain16_ms": rows[8][1], "kdf17_plain16_ms": rows[4][1],
        "kdf18_16it_ms": rows[8][4]["ms_at_plain_input"],
        "kdf17_16it_ms": rows[4][4]["ms_at_plain_input"],
        "aes18_step_ms": step_ms, "aes18_verdict_ms": verdict_ms}}))
    return timing


def sevenzip_line(rng, password: bytes, payload_len: int,
                  salt_len: int) -> str:
    """A stored 7-Zip entry holding ``payload_len`` seeded bytes under
    ``password`` at SEVENZIP_CYCLES, by the port's oracle run forward."""
    from dprf_tpu_torch.engines.cpu.sevenzip import encrypt
    salt = bytes(rng.integers(0, 256, salt_len, dtype="uint8"))
    iv = bytes(rng.integers(0, 256, 16, dtype="uint8"))
    payload = bytes(rng.integers(0, 256, payload_len, dtype="uint8"))
    return encrypt(password, payload, SEVENZIP_CYCLES, salt, iv)


def pdf_line(rng, password: bytes, rev: int, bits: int, meta: bool) -> str:
    """A $pdf$ line whose user password is ``password``: seeded O and
    ID, U by the port's oracle run forward."""
    from dprf_tpu_torch.engines.cpu.pdf import make_line
    o = bytes(rng.integers(0, 256, 32, dtype="uint8"))
    doc_id = bytes(rng.integers(0, 256, 16, dtype="uint8"))
    return make_line(password, rev, bits, o, -3904, doc_id, meta)


def slice_f3(smoke, cli, card, clock_mhz, sms) -> dict:
    """Phases 28-31: the 7-Zip KDF kernel of csrc/sevenzip.cu and the PDF
    kernel of csrc/pdf.cu.  Returns their timing rows (ms, plain ms,
    bound ms, bound_by, more); their main paths' launches go to
    smoke.path_launches."""
    import numpy as np
    import torch

    from dprf_tpu_torch.engines.cpu.sevenzip import sevenzip_key
    from dprf_tpu_torch.engines.device import sevenzip as dev7z
    from dprf_tpu_torch.generators.mask import MaskGenerator
    from dprf_tpu_torch.ops import cuda_7z, cuda_pdf, opcount
    from dprf_tpu_torch.runtime.potfile import decode_plain, encode_plain

    rng = smoke.rng
    gl8 = MaskGenerator(MASK_CONFIG5)
    lutl8 = gl8.charset_lut("cuda")
    b7 = dev7z.batch_for(gl8, dev7z.BATCH, torch.device("cuda"))
    nv7 = b7 - 3
    def clocked(fn, *args):
        """(fn(*args), its ms by CUDA events)."""
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = fn(*args)
        t1.record()
        torch.cuda.synchronize()
        return out, t0.elapsed_time(t1)

    # 28. the 7z KDF kernel vs its plain version at the main path's batch,
    # then hashlib at cycles 19
    phase(28)
    say(f"== 28. sevenzip_kdf (csrc/sevenzip.cu) vs plain over {nv7} valid "
        f"lanes of a batch of {b7}, the main path's (whole resident waves; "
        f"exact equality of every word), then hashlib at cycles "
        f"{SEVENZIP_CYCLES}")
    checks = {}
    for length, salt_len, cycles in SEVENZIP_CHECKS:
        gen = MaskGenerator("?l" * length if length == 8 else "?b" * length)
        lut = gen.charset_lut("cuda")
        salt = bytes(rng.integers(0, 256, salt_len, dtype=np.uint8))
        start = int(rng.integers(0, gen.keyspace - b7))
        args = (lut, gen.radices, gen.digits(start), nv7, salt, cycles, b7)
        k, ms_k = clocked(cuda_7z.sevenzip_kdf_kernel, *args)
        p, ms_p = clocked(cuda_7z.sevenzip_kdf_plain, *args)
        err = int((k.long() - p.long()).abs().max().item())
        smoke.err["sevenzip_kdf"] = max(smoke.err["sevenzip_kdf"], err)
        kk = k.cpu().numpy()
        oracle = all(kk[x].view(np.uint32).astype(">u4").tobytes()
                     == sevenzip_key(gen.candidate(start + x), salt, cycles)
                     for x in (0, nv7 - 1))
        comps = opcount.sevenzip_compressions(length, salt_len, cycles)
        checks[(length, salt_len, cycles)] = (ms_k, ms_p, comps)
        say(f"  L={length} salt {salt_len} B cycles {cycles} (unit "
            f"{cuda_7z.unit_bytes(length, salt_len)}, {comps} compressions): "
            f"{tuple(k.shape)} words, max |kernel - plain| = {err}; lanes 0 "
            f"and {nv7 - 1} equal hashlib: {oracle}; kernel {ms_k:.2f} ms, "
            f"plain {ms_p:.1f} ms")
        check(err == 0 and k.shape == (nv7, 8) and oracle,
              "sevenzip_kdf: kernel, plain and hashlib differ")
    # the CLI's window: its planted lanes are among the hashlib lanes
    skip7 = int(rng.integers(0, gl8.keyspace - b7))
    plants7 = [int(rng.integers(0, SEVENZIP_WINDOW - 1)),
               SEVENZIP_WINDOW - 1]
    args19 = (lutl8, gl8.radices, gl8.digits(skip7), nv7, b"",
              SEVENZIP_CYCLES, b7)
    k19, ms19 = clocked(cuda_7z.sevenzip_kdf_kernel, *args19)
    k19 = k19.cpu().numpy()
    lanes = [0, nv7 - 1, *plants7]
    lanes += [x for x in sorted({int(x) for x in rng.integers(
        1, nv7 - 1, 2 * SEVENZIP_HASHLIB_LANES)} - set(lanes))][
        :SEVENZIP_HASHLIB_LANES - len(lanes)]
    for x in lanes:
        check(k19[x].view(np.uint32).astype(">u4").tobytes()
              == sevenzip_key(gl8.candidate(skip7 + x), b"", SEVENZIP_CYCLES),
              f"sevenzip_kdf cycles {SEVENZIP_CYCLES} lane {x}: kernel and "
              "hashlib differ")
    say(f"  cycles {SEVENZIP_CYCLES} over {nv7} lanes of {MASK_CONFIG5}: "
        f"{len(lanes)} lanes (0, {nv7 - 1}, the CLI's planted {plants7}) "
        f"equal hashlib; {ms19:.1f} ms for the launch")

    # 29. the PDF kernel vs its plain version
    phase(29)
    g6 = MaskGenerator(MASK_PDF)
    lut6 = g6.charset_lut("cuda")
    say(f"== 29. pdf (csrc/pdf.cu) vs plain of {MASK_PDF}, the last 5 lanes "
        f"invalid: R2 at the main path's batch of {BATCH}, the R3 kinds at "
        f"{PDF_R3_CHECK_BATCH} (exact equality of the count and the sorted "
        "lanes; the password planted in the batch's second half, on a later "
        "pass of the grid-stride loop)")

    def plain_pieces(kind, start, n_valid, tgt):
        """pdf_plain over lanes [0, n_valid) from candidate ``start``, in
        pieces of PDF_PLAIN_CHUNK lanes: (count, sorted lanes)."""
        count, lanes = 0, []
        for off in range(0, n_valid, PDF_PLAIN_CHUNK):
            n = min(PDF_PLAIN_CHUNK, n_valid - off)
            c, ln = cuda_pdf.pdf_plain(kind, lut6, g6.radices,
                                       g6.digits(start + off), n, tgt, 64, n)
            count += int(c.item())
            lanes += [off + x for x in ln.tolist() if x >= 0]
        return count, sorted(lanes)

    pdf_plain_ms, pdf_check_ms, pdf_check_lanes = {}, {}, {}
    for rev, bits, meta in PDF_DOCS:
        batch = BATCH if rev == 2 else PDF_R3_CHECK_BATCH
        nvp = batch - 5
        start = int(rng.integers(0, g6.keyspace // batch)) * batch
        plant = int(rng.integers(nvp // 2, nvp))
        line = pdf_line(rng, g6.candidate(start + plant), rev, bits, meta)
        kind, tgt = cuda_pdf.target_kernel_args(
            smoke.get_engine("pdf").parse_target(line))
        name = cuda_pdf.KINDS[kind][1]
        args = (kind, lut6, g6.radices, g6.digits(start), nvp, tgt, 64,
                batch)
        kc, kl = cuda_pdf.pdf_kernel(*args)
        pf, plain_ms = clocked(plain_pieces, kind, start, nvp, tgt)
        kf = (int(kc.item()), sorted(x for x in kl.tolist() if x >= 0))
        err = max([abs(kf[0] - pf[0]), abs(len(kf[1]) - len(pf[1]))]
                  + [abs(a - b) for a, b in zip(kf[1], pf[1])])
        smoke.err["pdf"] = max(smoke.err["pdf"], err)
        wave = sms * cuda_pdf.THREADS * cuda_pdf.blocks_per_sm(
            kind, cuda_pdf.shared_bytes(g6.length))
        if (rev, meta) != (4, False):
            pdf_plain_ms[name] = plain_ms
            pdf_check_lanes[name] = nvp
            pdf_check_ms[name] = smoke.time_launches(cuda_pdf.pdf_kernel,
                                                     args, n=5)
        say(f"  {name} (R{rev}/{bits}{'' if meta else ', metadata in the '
            'clear'}) over {nvp} lanes, {nvp / wave:.2f} resident waves of "
            f"{wave}: kernel {kf} | plain {pf}, planted lane {plant} (pass "
            f"{plant // wave + 1}); plain {plain_ms:.1f} ms")
        check(kf == pf and plant in kf[1] and (rev == 2 or kf[0] == 1),
              f"pdf R{rev}/{bits}: kernel {kf}, plain {pf}, planted {plant}")

    # 30. the slice end to end through the CLI
    phase(30)
    say(f"== 30. crack --device cuda: 7z (two stored entries at cycles "
        f"{SEVENZIP_CYCLES}: no salt and a 100-byte payload; a 16-byte salt "
        f"and a {dev7z.DATA_CAP}-byte payload) over {SEVENZIP_WINDOW} of "
        f"{MASK_CONFIG5}; pdf (R2/40, R3/128, R4/128 with metadata in the "
        f"clear, R3/40) over {PDF_WINDOW} of {MASK_PDF}; card: {card}")
    e2e = {}
    planted = [gl8.candidate(skip7 + i) for i in plants7]
    lines7 = [sevenzip_line(rng, planted[0], 100, 0),
              sevenzip_line(rng, planted[1], dev7z.DATA_CAP, 16)]
    want = [f"{ln}:{encode_plain(p)}" for ln, p in zip(lines7, planted)]
    batches7 = -(-SEVENZIP_WINDOW // b7)
    summary, wall = run_path(smoke, cli, "7z", MASK_CONFIG5, lines7, want,
                             SEVENZIP_WINDOW, "sevenzip_kdf",
                             2 * batches7, skip7)
    e2e["7z"] = {"wall_s": wall, "rate": loop_rate(summary),
                 "planted_at": plants7, "skip": skip7, "batch": b7}
    say(f"  7z: {wall:.3f} s wall, 2 entries x {SEVENZIP_WINDOW} candidates "
        f"in launches of {b7}, loop {loop_rate(summary):,} candidates/s "
        "(x entries)")
    skip6 = int(rng.integers(0, g6.keyspace - PDF_WINDOW))
    idx = sorted({PDF_WINDOW - 1, *(int(x) for x in rng.integers(
        0, PDF_WINDOW - 1, len(PDF_DOCS) - 1))})
    check(len(idx) == len(PDF_DOCS), f"planted indices collide: {idx}")
    order = rng.permutation(len(PDF_DOCS))
    docs = [PDF_DOCS[i] for i in order]
    planted = [g6.candidate(skip6 + i) for i in idx]
    lines = [pdf_line(rng, p, *d) for p, d in zip(planted, docs)]
    want = [f"{ln}:{encode_plain(p)}" for ln, p in zip(lines, planted)]
    oracle = smoke.get_engine("pdf")

    def opens(got, want):
        """Every document found once, with its planted password or, for a
        40-bit document, another the oracle verifies: its RC4 key has 40
        bits, so a window of 2^28 holds a second password that opens it
        with chance 2^28 / 2^40, and the sweep reports the first."""
        if len(got) != len(want):
            return False
        for ln, (_, bits, _) in zip(lines, docs):
            mine = [g for g in got if g.startswith(ln + ":")]
            if len(mine) != 1:
                return False
            if mine[0] in want:
                continue
            plain = decode_plain(mine[0][len(ln) + 1:])
            t = oracle.parse_target(ln)
            if bits != 40 or oracle.hash_batch(
                    [plain], params=t.params)[0] != t.digest:
                return False
            say(f"  pdf: {ln[:24]}... opens with {plain!r} too, found "
                "before the planted password (a 40-bit key collision)")
        return True

    summary, wall, launches = smoke.crack_lines(
        cli, "pdf", ["--skip", str(skip6), "--limit", str(PDF_WINDOW),
                     MASK_PDF], lines, want, PDF_WINDOW, kernel_modules(),
        same=opens)
    per_doc = unit_batches(cli, PDF_WINDOW)
    by_kind = {}
    for rev, bits, _ in PDF_DOCS:
        name = cuda_pdf.KINDS[(2 if rev == 2 else 3, bits // 8)][1]
        by_kind[name] = by_kind.get(name, 0) + per_doc
    batches = int(re.search(r" batches=(\d+)", summary).group(1))
    maybes = int(re.search(r"maybes=(\d+)", summary).group(1))
    # an R2 document's maybe matches 32 bits: 2^-32 a candidate
    predicted = PDF_WINDOW * 2.0 ** -32
    check(all(launches[k] == n for k, n in by_kind.items())
          and sum(launches.values()) == batches == len(PDF_DOCS) * per_doc
          and maybes <= 5,
          f"pdf: launches {launches}, {batches} batches, expected {by_kind}"
          f"; maybes {maybes}, predicted {predicted:.4f}")
    for k, n in by_kind.items():
        smoke.path_launches[k] = n
    smoke.path_launches["pdf"] = sum(by_kind.values())
    e2e["pdf"] = {"wall_s": wall, "rate": loop_rate(summary),
                  "launches": by_kind, "planted_at": idx, "skip": skip6,
                  "maybes": maybes, "maybes_predicted": predicted}
    say(f"  pdf: {wall:.3f} s wall, {len(PDF_DOCS)} documents x "
        f"{PDF_WINDOW} candidates, loop {loop_rate(summary):,} candidates/s "
        f"(x documents)")
    say(json.dumps({"slice_f3": e2e}))

    # 31. timing
    phase(31)
    say(f"== 31. slice F3 timing (CUDA events); card: {card}")
    clock = clock_mhz * 1e6
    timing = {}
    bound7 = opcount.sevenzip_bound(nv7, gl8.length, 0, SEVENZIP_CYCLES, sms,
                                    clock)["issue"] * 1e3
    work = opcount.sevenzip_ops(gl8.length, 0, SEVENZIP_CYCLES)
    comps = opcount.sevenzip_compressions(gl8.length, 0, SEVENZIP_CYCLES)
    ms_k, ms_p, comps10 = checks[(8, 0, 10)]
    timing["sevenzip_kdf"] = (ms19, ms_p, bound7, "operations", {
        "plain_input": f"{nv7} lanes of ?l^8 at cycles 10 (ms: the same "
                       f"lanes at cycles {SEVENZIP_CYCLES})",
        "ms_at_plain_input": ms_k})
    smem = cuda_7z.shared_bytes(gl8.length)
    say(f"  sevenzip_kdf {MASK_CONFIG5} at cycles {SEVENZIP_CYCLES}: "
        f"{ms19:.1f} ms per launch of {nv7} = {nv7 / ms19 * 1e3:,.0f} "
        f"candidates/s = {nv7 * comps / ms19 / 1e6:.3f} G SHA-256 "
        f"compressions/s ({comps} a candidate); bound {bound7:.1f} ms "
        f"({work.slots:,.0f} slots a candidate); kernel at "
        f"{bound7 / ms19:.1%} of it; {smem} B shared, "
        f"{cuda_7z.blocks_per_sm(smem)} resident blocks of "
        f"{cuda_7z.THREADS} per SM.  At cycles 10 ({comps10} compressions): "
        f"kernel {ms_k:.2f} ms, plain version {ms_p:.1f} ms")
    # one step of the main path (the 1,024-byte entry) and its verdict
    params = smoke.get_engine("7z").parse_target(lines7[1]).params
    step = dev7z.make_kernel_step(gl8, b7, params, 64, "cuda")
    check_fn = dev7z.make_state_check(params, "cuda")
    words = torch.as_tensor(k19, device="cuda")
    verdict_ms = smoke.time_launches(check_fn, (words,), n=3, warm=1)
    step_ms = smoke.time_once(step, (gl8.digits(skip7), nv7), warm=False)
    say(f"  7z step of {nv7} (the entry with a 16-byte salt, a "
        f"{cuda_7z.unit_bytes(gl8.length, 16)}-byte unit, and a "
        f"{dev7z.DATA_CAP}-byte payload): "
        f"{step_ms:.1f} ms; the torch verdict alone (AES-256-CBC of "
        f"{dev7z.DATA_CAP // 16} blocks, CRC32 of {dev7z.DATA_CAP} bytes) "
        f"{verdict_ms:.2f} ms = {verdict_ms / step_ms:.2%} of the step")
    rows = {}
    for kind, (_, name) in cuda_pdf.KINDS.items():
        line = pdf_line(rng, b"\0" * 7, kind[0], 8 * kind[1], True)
        _, tgt = cuda_pdf.target_kernel_args(
            smoke.get_engine("pdf").parse_target(line))
        start = int(rng.integers(0, g6.keyspace // BATCH)) * BATCH
        args = (kind, lut6, g6.radices, g6.digits(start), BATCH, tgt, 64,
                BATCH)
        ms = smoke.time_launches(cuda_pdf.pdf_kernel, args, n=5)
        lim = opcount.pdf_bound(BATCH, g6.length, *kind, sms, clock)
        bound = max(lim.values()) * 1e3
        work = opcount.pdf_ops(g6.length, *kind)
        rows[name] = {"ms": ms, "bound_ms": bound,
                      "bound_limit": max(lim, key=lim.get),
                      "plain_ms": pdf_plain_ms[name],
                      "plain_lanes": pdf_check_lanes[name],
                      "ms_at_plain_input": pdf_check_ms[name],
                      "launches": smoke.path_launches[name]}
        say(f"  {name} {MASK_PDF}: {ms:.3f} ms per launch of {BATCH} = "
            f"{BATCH / ms / 1e3:,.3f} M candidates/s; bound {bound:.3f} ms "
            f"({max(lim, key=lim.get)}: issue {lim['issue'] * 1e3:.3f} ms at "
            f"{work.slots:,.1f} slots a candidate, shared "
            f"{lim['shared'] * 1e3:.3f} ms at "
            f"{opcount.pdf_shared(kind[0]) + g6.length} accesses); kernel at "
            f"{bound / ms:.1%} of it; plain version {pdf_plain_ms[name]:.1f} "
            f"ms over {pdf_check_lanes[name]} lanes (kernel there "
            f"{pdf_check_ms[name]:.3f} ms)")
    main = rows["pdf_r3_128"]
    timing["pdf"] = (main["ms"], main["plain_ms"], main["bound_ms"],
                     "operations", {
                         "bound_limit": main["bound_limit"],
                         "plain_input": f"{main['plain_lanes']} lanes "
                                        f"(ms: {BATCH})",
                         "ms_at_plain_input": main["ms_at_plain_input"],
                         "instantiations": rows})
    say(json.dumps({"slice_f3_timing": {
        "sevenzip_kdf_ms": ms19, "sevenzip_kdf_bound_ms": bound7,
        "sevenzip_kdf_plain10_ms": ms_p, "sevenzip_kdf_10_ms": ms_k,
        "sevenzip_step_ms": step_ms, "sevenzip_verdict_ms": verdict_ms,
        "pdf": rows}}))
    return timing



def window_case(smoke, engine, mode, gen, lut, start, offset, n_valid,
                plants, name, n_targets=N_TARGETS):
    """One window case of the mask kernel (compare ``mode``) against its
    plain version at a window offset: lanes [offset, n_valid) of a batch
    of 2^24 from ``start``; the planted candidates' digests first, then
    fillers up to ``n_targets`` for a list.  Count, (lane, table
    position) pairs and n_maybe must be equal, and the hits the plants
    inside the window."""
    cm, torch = smoke.cm, smoke.torch
    digests = smoke.get_engine(engine).hash_batch(
        [gen.candidate(p) for p in plants])
    base = (engine, lut, gen.radices, gen.digits(start), n_valid)
    order = [0]
    if mode == 0:
        args = (*base, digest_words(engine, digests[0]), 64, BATCH)
        kernel, plain = cm.mask_kernel, cm.mask_plain
    else:
        digests += smoke.fillers(engine, n_targets - len(plants))
        table, rows, words = smoke.tables(engine, digests)
        order = table.order
        if mode == 1:
            args = (*base, rows, words, 64, BATCH)
            kernel, plain = cm.mask_multi_kernel, cm.mask_multi_plain
        else:
            bits, block_bits, k = cm.probe_rows(table.words)
            args = (*base, torch.as_tensor(bits.view(smoke.np.int32),
                                           device="cuda"),
                    block_bits, k, words, 64, BATCH)
            kernel, plain = cm.mask_probe_kernel, cm.mask_probe_plain
    got = kernel(*args, offset=offset)
    want = plain(*args, offset=offset)
    torch.cuda.synchronize()

    def flat(out):
        tpos = out[2].tolist() if mode else [0] * out[1].shape[0]
        pairs = sorted((int(a), int(b)) for a, b in
                       zip(out[1].tolist(), tpos) if a >= 0)
        return (int(out[0].item()), pairs,
                int(out[3].item()) if mode else 0)

    (kc, kp, km), (pc, pp, pm) = flat(got), flat(want)
    err = max([abs(kc - pc), abs(km - pm)]
              + [abs(a - b) for x, y in zip(kp, pp) for a, b in zip(x, y)])
    key = kname(engine, mode)
    hits = [(lane, int(order[t])) for lane, t in kp]
    expect = [(p - start, i) for i, p in enumerate(plants)
              if offset <= p - start < n_valid][:1 if mode == 0 else None]
    say(f"  {key} {name}: kernel count={kc} (lane, target)={hits} "
        f"n_maybe={km} | plain count={pc} n_maybe={pm}")
    check((kc, kp, km) == (pc, pp, pm), f"{key} {name}: kernel and plain "
          "differ")
    check(hits == expect, f"{key} {name}: hits {hits}, expected {expect}")
    smoke.err[key] = max(smoke.err.get(key, 0), err)


def sharded_path(smoke, cli, engine, gen, digests, planted, skip, window,
                 meshes):
    """The sharded mask worker (``make_sharded_mask_worker``, the CLI's
    entry for --devices N) over [skip, skip + window) in the CLI's
    units, on each mesh, with every launch count set to 0 just before
    it and read just after: only the instantiation of the job's compare
    (one target exact, a list the probe), once per shard and batch.
    The found set must equal the single-device worker's and the plants.
    Returns {mesh size: wall s}."""
    import torch

    from dprf_tpu_torch import get_engine
    from dprf_tpu_torch.runtime.workunit import WorkUnit

    dev = get_engine(engine, device="cuda", torch_device="cuda")
    oracle = smoke.get_engine(engine)
    targets = [dev.parse_target(d.hex()) for d in digests]
    want = sorted((digests.index(d), gen.index_of(p))
                  for d, p in zip(oracle.hash_batch(planted), planted))
    key = kname(engine, 2 if len(digests) > 1 else 0)

    def sweep(worker):
        units = [WorkUnit(i, u, min(cli.UNIT_BATCHES * worker.stride,
                                    skip + window - u))
                 for i, u in enumerate(range(
                     skip, skip + window,
                     cli.UNIT_BATCHES * worker.stride))]
        pending = [worker.submit(u) for u in units]
        hits = [h for p in pending for h in p.resolve()]
        torch.cuda.synchronize()
        return sorted((h.target_index, h.cand_index) for h in hits)

    single = dev.make_mask_worker(gen, targets, batch=BATCH,
                                  hit_capacity=64, oracle=oracle)
    base = sweep(single)
    check(base == want, f"{engine}: the single-device worker found {base}, "
          f"expected {want}")
    walls = {}
    for mesh in meshes:
        for mod in kernel_modules():
            mod.reset_launches()
        t0 = time.perf_counter()
        worker = dev.make_sharded_mask_worker(gen, targets, mesh, BATCH,
                                              hit_capacity=64,
                                              oracle=oracle)
        got = sweep(worker)
        wall = time.perf_counter() - t0
        launches = {k: v for mod in kernel_modules()
                    for k, v in mod.launches.items()}
        n = len(mesh) * worker.dispatched
        check(got == base, f"{engine} on {len(mesh)} shards found {got}, "
              f"the single-device worker {base}")
        check(launches[key] == n == sum(launches.values()) and n > 0,
              f"{key} on {len(mesh)} shards: launches {launches}, "
              f"expected {n}")
        if len(mesh) == SHARDS:
            smoke.path_launches.setdefault(key, n)
        walls[len(mesh)] = wall
        say(f"  {engine} x {len(digests)} target(s), {window} candidates "
            f"on {len(mesh)} shard(s): {len(got)} found (= the "
            f"single-device worker's), {worker.dispatched} strides in "
            f"{worker.windows} sharded windows, {key} launches={n}, "
            f"maybes={worker.n_maybe()}, {wall:.3f} s wall")
    return walls


def loop_ab(smoke, cli, engine, gen, digests, skip, window) -> dict:
    """The loop superstep against one launch a batch in one call: the
    single-device worker over [skip, skip + window) in the CLI's units,
    its windows as built (``loop``) and with ``window_batches`` set to
    1 (``batch``), in the order loop, batch, batch, loop; every sweep's
    hits must be equal.  Returns the wall clock of each order's runs
    and their sums."""
    import torch

    from dprf_tpu_torch import get_engine
    from dprf_tpu_torch.runtime.workunit import WorkUnit

    dev = get_engine(engine, device="cuda", torch_device="cuda")
    targets = [dev.parse_target(d.hex()) for d in digests]
    oracle = smoke.get_engine(engine)
    unit = cli.UNIT_BATCHES * BATCH
    units = [WorkUnit(i, u, min(unit, skip + window - u))
             for i, u in enumerate(range(skip, skip + window, unit))]
    walls = {"loop": [], "batch": []}
    found = set()
    for mode in ("loop", "batch", "batch", "loop"):
        worker = dev.make_mask_worker(gen, targets, batch=BATCH,
                                      hit_capacity=64, oracle=oracle)
        if mode == "batch":
            worker.window_batches = 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = [worker.submit(u) for u in units]
        hits = [h for p in pending for h in p.resolve()]
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
        found.add(tuple(sorted((h.target_index, h.cand_index)
                               for h in hits)))
        check(worker.windows == (len(units) if mode == "loop" else 0),
              f"{engine} {mode}: {worker.windows} windows")
    check(len(found) == 1, f"{engine}: the loop and the per-batch sweeps "
          f"found different sets {found}")
    out = {m: {"runs_s": w, "sum_s": sum(w)} for m, w in walls.items()}
    say(f"  {engine} x {len(digests)} over {window} candidates, "
        f"{len(units)} units: loop {walls['loop']} s, one launch a batch "
        f"{walls['batch']} s; loop / batch "
        f"{sum(walls['loop']) / sum(walls['batch']):.4f}")
    return out


def slice_g(smoke, cli, card, rate_ops, g6, lut6, g7, lut7) -> dict:
    """Phases 32-34: the window offset and the blocked probe of
    csrc/mask.cu, the sharded path, the probe's timing.  Returns the
    probe instantiations' timing rows (ms, plain ms, bound ms); the
    sharded path's launches go to smoke.path_launches."""
    import numpy as np
    import torch

    from dprf_tpu_torch.generators.mask import MaskGenerator
    from dprf_tpu_torch.ops import bloom, cuda_mask, opcount
    from dprf_tpu_torch.parallel import make_mesh

    rng = smoke.rng
    # 32. kernel vs plain at a window offset
    phase(32)
    offset, nv = 2 * BATCH, 3 * BATCH - 3
    say(f"== 32. slice G: the probe and the window offset vs plain, "
        f"?a^7, window lanes [{offset}, {nv}) of a batch of {BATCH} "
        f"(exact equality)")
    for engine in PROBE_CORES:
        for n in PROBE_TARGETS:
            blocks = 1 << cuda_mask.probe_rows(
                np.zeros((n, 4), np.uint32))[1]
            smem = cuda_mask.shared_bytes(7, probe_blocks=blocks)
            say(f"  {kname(engine, PROBE)} at {n} targets: {blocks} blocks "
                f"of 64 B, {smem} B shared, "
                f"{cuda_mask.blocks_per_sm(engine, PROBE, smem)} resident "
                f"blocks of {cuda_mask.THREADS} per SM")
    start = int(rng.integers(0, g7.keyspace // BATCH - 4)) * BATCH
    for engine in PROBE_CORES:
        smem = cuda_mask.shared_bytes(7, probe_blocks=128)
        blocks = cuda_mask.blocks_per_sm(engine, PROBE, smem)
        r, b = g7.radices[-1], g7.digits(start)[-1]
        if cuda_mask.lanes_a_run(engine, g7.radices) > 1:
            # a lane of the last run of the grid-stride loop's last pass
            n_runs = cuda_mask.run_count(r, b, offset, nv)
            threads = cuda_mask.run_grid(blocks, n_runs, "cuda") \
                * cuda_mask.THREADS
            passes = -(-n_runs // threads)
            done = (passes - 1) * threads
            lo, hi, _ = cuda_mask.run_lanes(r, b, offset, nv,
                                            done + (n_runs - done) // 2)
            late = lo + (hi - lo) // 2
            where = (f"pass {passes - 1} of {threads} threads' loop over "
                     f"{n_runs} runs")
        else:
            threads = cuda_mask.wave_grid(blocks, nv - offset, "cuda") \
                * cuda_mask.THREADS
            late = offset + (BATCH // threads - 1) * threads + 777
            where = (f"pass {(late - offset) // threads} of {threads} "
                     "threads' grid-stride loop")
        plants = [start + offset, start + late, start + late + 1,
                  start + nv - 1, start + nv, start + offset - 1]
        window_case(smoke, engine, PROBE, g7, lut7, start, offset, nv,
                    plants, f"{N_TARGETS} targets, hits at the window's "
                    f"first lane, lanes {late} and {late + 1} ({where}), "
                    "the last valid lane; one at n_valid, one before the "
                    "offset")
    g55 = MaskGenerator("?a" * 7 + "?d" * 48)
    s55 = int(rng.integers(0, 1 << 62)) * BATCH
    window_case(smoke, "md5", PROBE, g55, g55.charset_lut("cuda"), s55,
                offset, nv, [s55 + offset, s55 + nv - 1],
                f"?a^7?d^48 at {bloom.MAX_TARGETS} targets (a 64 KB bitmap "
                "after 14,080 B of charset tables)",
                n_targets=bloom.MAX_TARGETS)
    window_case(smoke, "md5", 0, g6, lut6, 0, offset, nv, [offset + 4321],
                "?l^6, one target")
    window_case(smoke, "ntlm", 1, g7, lut7, start, offset, nv,
                [start + offset, start + nv - 1], "the Bloom sets, "
                f"{N_TARGETS} targets")
    loops = {name: {"wall_s": wall, "windows": windows, "launches": batches,
                    "pr8_wall_s": PR8_WALL[name]}
             for name, (wall, windows, batches) in smoke.loop_walls.items()}
    say(f"  configs 1 and 2 through the loop superstep (phases 4-5): "
        f"{json.dumps(loops)}; card: {card}")
    say(f"  the loop superstep vs one launch a batch, in this call "
        f"(worker sweeps, wall clock); card: {card}")
    ab = {"config1": loop_ab(
        smoke, cli, "md5", g6,
        smoke.get_engine("md5").hash_batch([g6.candidate(12345)]), 0,
        g6.keyspace)}
    skip = int(rng.integers(0, g7.keyspace - CONFIG2_WINDOW))
    ab["config2"] = loop_ab(
        smoke, cli, "ntlm", g7,
        smoke.get_engine("ntlm").hash_batch([g7.candidate(skip + 77)])
        + smoke.fillers("ntlm", N_TARGETS - 1), skip, CONFIG2_WINDOW)
    say(json.dumps({"loop_ab": ab}))

    # 33. the sharded path: a mesh of the card, and SHARDS shards of it
    phase(33)
    say(f"== 33. the sharded path: make_sharded_mask_worker over a mesh of "
        f"the card and over {SHARDS} shards of it, {BATCH} lanes a shard "
        f"and launch; card: {card}")
    meshes = (make_mesh(1), make_mesh(devices=["cuda:0"] * SHARDS))
    skip = int(rng.integers(0, g7.keyspace - CONFIG2_WINDOW))
    idx = sorted({0, CONFIG2_WINDOW - 1, BATCH - 1, BATCH, 4 * BATCH - 1,
                  4 * BATCH, *(int(x) for x in rng.integers(
                      1, CONFIG2_WINDOW - 1, 2))})
    planted = [g7.candidate(skip + i) for i in idx]
    ntlm = smoke.get_engine("ntlm").hash_batch(planted)
    sharded = {}
    for n in PROBE_TARGETS:
        digests = ntlm + smoke.fillers("ntlm", n - len(planted))
        sharded[f"ntlm_{n}"] = sharded_path(
            smoke, cli, "ntlm", g7, digests, planted, skip, CONFIG2_WINDOW,
            meshes)
    plain = g6.candidate(g6.keyspace - 1)
    sharded["md5_1"] = sharded_path(
        smoke, cli, "md5", g6, smoke.get_engine("md5").hash_batch([plain]),
        [plain], 0, g6.keyspace, meshes)
    for engine in PROBE_CORES:
        if engine == "ntlm":
            continue
        skip = int(rng.integers(0, g7.keyspace - OTHER_WINDOW))
        planted = [g7.candidate(skip + int(i)) for i in
                   sorted(set(rng.integers(0, OTHER_WINDOW, 3).tolist()))]
        digests = smoke.get_engine(engine).hash_batch(planted) + \
            smoke.fillers(engine, N_TARGETS - len(planted))
        sharded[f"{engine}_{N_TARGETS}"] = sharded_path(
            smoke, cli, engine, g7, digests, planted, skip, OTHER_WINDOW,
            meshes)
    say(json.dumps({"sharded_wall_s": sharded}))

    # 34. the probe against the Bloom sets at 2^24 a launch
    phase(34)
    say(f"== 34. the probe vs the Bloom sets at batch 2^24, ?a^7 (CUDA "
        f"events, {TIMED_LAUNCHES} launches, the SM clock sampled over the "
        f"phase); card: {card}")
    timing = {}
    with SmClock() as clock:
        for engine in PROBE_CORES:
            s = int(rng.integers(0, g7.keyspace // BATCH)) * BATCH
            for n in PROBE_TARGETS:
                table, rows, words = smoke.tables(engine,
                                                  smoke.fillers(engine, n))
                base = (engine, lut7, g7.radices, g7.digits(s), BATCH)
                sets_args = (*base, rows, words, 64, BATCH)
                bits, block_bits, k = cuda_mask.probe_rows(table.words)
                probe_args = (*base, torch.as_tensor(bits.view(np.int32),
                                                     device="cuda"),
                              block_bits, k, words, 64, BATCH)
                ms_sets = smoke.time_launches(cuda_mask.mask_multi_kernel,
                                              sets_args)
                ms_probe = smoke.time_launches(cuda_mask.mask_probe_kernel,
                                               probe_args)
                m_sets = int(cuda_mask.mask_multi_kernel(*sets_args)[3].item())
                m_probe = int(cuda_mask.mask_probe_kernel(*probe_args)[3]
                              .item())
                run = cuda_mask.lanes_a_run(engine, g7.radices)
                w_sets = opcount.ops_per_candidate(
                    engine, 7, True,
                    bloom.expected_probes(rows.cpu().numpy().view(np.uint32)),
                    m_sets / BATCH, n, run=run)
                fill = opcount.probe_fill(bits)
                w_probe = opcount.probe_ops(engine, 7, fill, k,
                                            m_probe / BATCH, n, run=run)
                b_sets = BATCH * w_sets.slots / rate_ops * 1e3
                b_probe = BATCH * w_probe.slots / rate_ops * 1e3
                say(f"  {engine} x {n}: probe {ms_probe:.4f} ms (bound "
                    f"{b_probe:.4f} ms, {w_probe.slots:.1f} slots, "
                    f"{b_probe / ms_probe:.1%}; fill {fill:.4f}, k {k}, "
                    f"maybes {m_probe}) | sets {ms_sets:.4f} ms (bound "
                    f"{b_sets:.4f} ms, {w_sets.slots:.1f} slots, "
                    f"{b_sets / ms_sets:.1%}; maybes {m_sets}); probe/sets "
                    f"{ms_probe / ms_sets:.3f}")
                if n == N_TARGETS:
                    plain_ms = smoke.time_once(cuda_mask.mask_probe_plain,
                                               probe_args)
                    timing[kname(engine, PROBE)] = (ms_probe, plain_ms,
                                                    b_probe, {})
                    say(f"    plain probe version {plain_ms:.2f} ms")
                timing[f"{engine}_{n}"] = {"probe_ms": ms_probe,
                                           "sets_ms": ms_sets,
                                           "probe_bound_ms": b_probe,
                                           "sets_bound_ms": b_sets,
                                           "probe_maybes": m_probe,
                                           "sets_maybes": m_sets}
    say(f"  the SM clock over the phase: {clock.mhz} MHz (nvidia-smi, "
        f"{len(clock.samples)} samples); card: {card}")
    for engine in PROBE_CORES:
        key = kname(engine, PROBE)
        ms, _, bound, more = timing[key]
        more.update(clock_keys(bound, clock.mhz, smoke.clock_mhz))
        say(f"    {key}: {ms:.4f} ms, parent {PARENT_MS[key]:.4f} ms "
            f"(x{PARENT_MS[key] / ms:.3f}); kernel at "
            f"{more['bound_ms_at_sm_mhz'] / ms:.1%} of the bound at the "
            "sampled clock")
    say(json.dumps({"slice_g_timing": {k: v for k, v in timing.items()
                                       if isinstance(v, dict)}}))
    return timing


def l_lines(engine: str, digests: list, salts: list) -> list:
    """Target lines of a slice L engine in its own format: bare hex,
    ``{SHA}`` / ``{MD5}`` base64, ``hex:$HEX[salt]``, MSSQL's
    ``0x0100`` / ``0x0200`` (2000 with its case-sensitive digest first)."""
    import base64
    out = []
    for d, salt in zip(digests, salts):
        if engine in ("ldap-sha", "ldap-md5"):
            out.append("{" + engine[5:].upper() + "}"
                       + base64.b64encode(d).decode())
        elif engine.startswith("mssql"):
            tag = "0200" if engine == "mssql2012" else "0100"
            case = d.hex() if engine == "mssql2000" else ""
            out.append(f"0x{tag}{(salt.hex() + case + d.hex()).upper()}")
        elif salt is not None:
            out.append(f"{d.hex()}:$HEX[{salt.hex()}]")
        else:
            out.append(d.hex())
    return out


def l_plants(rng, n_lines: int, window: int, skip: int = 0) -> list:
    """Indices of the planted targets of a slice L CLI run: one target
    at the window's last candidate (the whole window swept); a list's
    3 at its first, its last and a random one."""
    if n_lines == 1:
        return [skip + window - 1]
    idx = sorted({skip, skip + window - 1,
                  skip + int(rng.integers(1, window - 1))})
    check(len(idx) == 3, f"planted indices collide: {idx}")
    return idx


def l_path(smoke, cli, engine, gen, n_lines, key, n_launches, salt_of=None,
           window=None, skip=0, mask=None):
    """crack --device cuda of ``engine`` over ``n_lines`` targets in its
    own line format (3 planted, the rest out of the mask's reach), each
    with its salt (``salt_of(i)``, or none), over ``window`` candidates
    from ``skip`` (default: the whole keyspace): only ``key`` launches,
    ``n_launches`` times.  Returns (summary, wall s)."""
    import numpy as np

    from dprf_tpu_torch.runtime.potfile import encode_plain
    rng = smoke.rng
    window = window or gen.keyspace - skip
    idx = l_plants(rng, n_lines, window, skip)
    oracle = smoke.get_engine(engine)
    salts = [salt_of(i) if salt_of else None for i in range(n_lines)]
    plains = [gen.candidate(i) for i in idx] + [
        bytes(rng.integers(33, 127, 9, dtype=np.uint8))
        for _ in range(n_lines - len(idx))]
    digests = [oracle.hash_batch([p], None if s is None else {"salt": s})[0]
               for p, s in zip(plains, salts)]
    lines = l_lines(engine, digests, salts)
    order = rng.permutation(n_lines)
    want = [f"{lines[i]}:{encode_plain(plains[i])}" for i in range(len(idx))]
    summary, wall = run_path(smoke, cli, engine, mask or gen.mask,
                             [lines[i] for i in order], want, window, key,
                             n_launches, skip)
    say(f"    {engine} x {n_lines}: {wall:.3f} s wall, rate "
        f"{loop_rate(summary):,}/s; planted at {idx}")
    return summary, wall


def l_group(smoke, variant, engine, gen, lut, start, n_valid, batch, n_group,
            salt_of, lanes_of, name, plain=True):
    """One launch of the salted variant over a group of ``n_group``
    targets of ``engine`` (``salt_of(i)`` its salts; ``lanes_of`` {target:
    lane} the plants), the kernel against its plain version (``plain``)
    or against the plants alone: equal count, (lane, target) pairs and
    per-target counts, the pairs the plants inside [0, n_valid).  Returns
    the plain version's ms (CUDA events) or None."""
    import torch

    from dprf_tpu_torch.ops import cuda_ext
    oracle = smoke.get_engine(engine)
    targets, want = [], []
    for i in range(n_group):
        salt = salt_of(i)
        lane = lanes_of.get(i)
        cand = gen.candidate(start + lane) if lane is not None \
            else b"\0" * (gen.length + 1)
        d = oracle.hash_batch([cand], params={"salt": salt})[0]
        if lane is not None and lane < n_valid:
            want.append((lane, i))
        targets.append((salt, digest_words(engine, d)))
    rows, shift = cuda_ext.salted_table(variant, gen.length, targets, "cuda")
    args = (variant, lut, gen.radices, gen.digits(start), n_valid, shift,
            rows, 64 * n_group, batch)
    key = f"{variant}_group"

    def flat(count, lanes, tpos, tcount):
        return (int(count.item()), sorted(
            (int(a), int(b)) for a, b in zip(lanes.tolist(), tpos.tolist())
            if a >= 0), tcount.tolist())

    got = flat(*cuda_ext.salted_kernel(*args))
    counts = [sum(1 for _, t in want if t == i) for i in range(n_group)]
    say(f"  {key} {name}: kernel count={got[0]} (lane, target)={got[1]}")
    check(got == (len(want), sorted(want), counts),
          f"{key} {name}: hits {got[1]}, expected the plants {sorted(want)}")
    if not plain:
        return None
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    ref = cuda_ext.salted_plain(*args)
    t1.record()
    torch.cuda.synchronize()
    ref = flat(*ref)
    err = max([abs(got[0] - ref[0])]
              + [abs(a - b) for x, y in zip(got[1], ref[1])
                 for a, b in zip(x, y)]
              + [abs(a - b) for a, b in zip(got[2], ref[2])])
    smoke.err[key] = max(smoke.err[key], err)
    ms = t0.elapsed_time(t1)
    say(f"    plain count={ref[0]} (lane, target)={ref[1]}, {ms:.1f} ms for "
        f"{n_group} targets x {batch} lanes")
    check(got == ref, f"{key} {name}: kernel and plain differ")
    return ms


def slice_l(smoke, cli, card, rate_ops, g6, lut6, g7, lut7) -> dict:
    """Phases 35-38: slice L -- sha224 and mysql323, two cores of the mask
    kernel template (csrc/mask.cu), and the salted kernel's wide sha512
    variants and MSSQL's UTF-16LE placements (csrc/salted.cuh), none of
    which the reference has a Pallas kernel for.  Returns their timing
    rows (ms, plain ms, bound ms, more) by instantiation; their main
    paths' launches go to smoke.path_launches."""
    import numpy as np
    import torch

    from dprf_tpu_torch.generators.mask import MaskGenerator
    from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
    from dprf_tpu_torch.ops import bloom, cuda_ext, cuda_mask, opcount
    from dprf_tpu_torch.parallel import make_mesh
    from dprf_tpu_torch.rules import load_rules
    from dprf_tpu_torch.runtime.potfile import encode_plain

    rng = smoke.rng
    phase(None)
    say(f"  phases 1-34: {json.dumps(PHASE_S)} s")
    t_phase = time.perf_counter()

    def alnum(n: int) -> bytes:
        return bytes(rng.choice(np.frombuffer(ALNUM, np.uint8), n))

    # 35. the new instantiations against their plain versions
    say(f"== 35. slice L kernels vs plain (exact equality); card: {card}")
    base = int(rng.integers(0, g7.keyspace // BATCH - 2)) * BATCH
    nv = BATCH - 1000
    smoke.single_case("sha224", g7, lut7, base, BATCH, base, 64, [0],
                      "?a^7 hit at lane 0")
    smoke.single_case("sha224", g7, lut7, base + BATCH, nv,
                      base + BATCH + nv - 1, 64, [nv - 1],
                      f"?a^7 hit at last valid lane, n_valid={nv}")
    smoke.single_case("sha224", g7, lut7, base, BATCH, None, 64, [],
                      "?a^7 no hit")
    smoke.multi_case("sha224", g7, lut7, base, nv,
                     [base, base + 64, base + 65, base + nv - 1, base + nv],
                     f"?a^7 {N_TARGETS} targets, hits at lanes 0, 64, 65, "
                     f"n_valid-1 and n_valid={nv}")
    smoke.multi_case("sha224", g7, lut7, base + BATCH, BATCH, [base],
                     "?a^7 no hit")
    offset = 12347
    for engine, gen, lut in (("sha224", g7, lut7), ("mysql323", g6, lut6)):
        start = int(rng.integers(0, gen.keyspace // BATCH - 1)) * BATCH
        plants = sorted([start + offset, start + offset + 1,
                         start + offset + 5000, start + nv - 1, start + nv,
                         start + offset - 1])
        window_case(smoke, engine, PROBE, gen, lut, start, offset, nv,
                    plants, f"{gen.mask} at {N_TARGETS} targets, window "
                    f"[{offset}, {nv})")
    s6 = 3 * BATCH
    nv6 = BATCH - 1000
    smoke.single_case("mysql323", g6, lut6, s6, BATCH, s6, 64, [0],
                      "?l^6 hit at lane 0")
    smoke.single_case("mysql323", g6, lut6, s6 + BATCH, nv6,
                      s6 + BATCH + nv6 - 1, 64, [nv6 - 1],
                      f"?l^6 hit at last valid lane, n_valid={nv6}")
    smoke.single_case("mysql323", g6, lut6, s6, BATCH, None, 64, [],
                      "?l^6 no hit")
    # spaces and tabs: ?a^7 holds the space, a custom position the tab;
    # a plant with both collides with its other arrangements, which the
    # kernel and the plain version must count alike
    gsp = MaskGenerator("?a?a?a?a?a?1?1", {1: b"ab \t"})
    lsp = gsp.charset_lut("cuda")
    ssp = int(rng.integers(0, gsp.keyspace // BATCH - 1)) * BATCH
    lane = next(x for x in range(BATCH // 2, BATCH)
                if b" " in gsp.candidate(ssp + x)[:5]
                and b"\t" in gsp.candidate(ssp + x)[5:])
    target = digest_words("mysql323", smoke.get_engine("mysql323")
                          .hash_batch([gsp.candidate(ssp + lane)])[0])
    args = ("mysql323", lsp, gsp.radices, gsp.digits(ssp), BATCH, target,
            4096, BATCH)
    k, p = cuda_mask.mask_kernel(*args), cuda_mask.mask_plain(*args)
    torch.cuda.synchronize()
    kc, pc = int(k[0].item()), int(p[0].item())
    kl = sorted(x for x in k[1].tolist() if x >= 0)
    pl = sorted(x for x in p[1].tolist() if x >= 0)
    say(f"  mysql323_mask {gsp.mask} (space, tab), plant "
        f"{gsp.candidate(ssp + lane)!r} at lane {lane}: kernel count={kc} | "
        f"plain count={pc}; the collisions {kl[:8]}")
    check((kc, kl) == (pc, pl) and lane in kl and kc > 1,
          "mysql323 with spaces and tabs: kernel and plain differ")

    # the salted variants at the path's group of 256: each launch of 2^24
    # held to the hashlib plants (the plain version runs the core in torch
    # a target at a time), and against the plain version at L_CHECK_LANES
    n_group = cuda_ext.SALTED_GROUP
    plain_ms = {}
    for variant, engine, salt_of in (
            ("sha512-ps", "sha512-ps", lambda i: alnum(i % 33)),
            ("sha512-sp", "sha512-sp", lambda i: alnum(32)),
            ("sha1-ps-utf16", "mssql2005", lambda i: alnum(4)),
            ("sha1-ps-utf16", "mssql2000", lambda i: alnum(4)),
            ("sha512-ps-utf16", "mssql2012", lambda i: alnum(4))):
        dev = smoke.get_engine(engine, "cuda")
        lut = cuda_ext.mapped_lut(g6, "cuda", dev.byte_map)
        salts = {i: salt_of(i) for i in range(n_group)}
        for batch in (BATCH, L_CHECK_LANES[variant]):
            nvs = batch - 9
            start = int(rng.integers(0, g6.keyspace // batch - 1)) * batch
            rnd, rnd2 = (int(x) for x in rng.integers(1, nvs - 1, 2))
            lanes_of = {0: rnd, 201: 0, 230: nvs - 1, 254: rnd,
                        n_group - 1: nvs - 1, 240: nvs, 222: rnd2}
            ms = l_group(smoke, variant, engine, g6, lut, start, nvs, batch,
                         n_group, salts.get, lanes_of,
                         f"{engine}, ?l^6, {n_group} targets x {batch} "
                         f"lanes, plants at target positions "
                         f"{sorted(lanes_of)}", plain=batch != BATCH)
            if ms is not None:
                plain_ms[engine] = (ms, batch)
    # sha512-sp: a group of another salt length, the empty salt
    l_group(smoke, "sha512-sp", "sha512-sp", g6, lut6, 0,
            L_CHECK_LANES["sha512-sp"] - 9, L_CHECK_LANES["sha512-sp"], 8,
            lambda i: b"", {3: 0, 5: 77},
            "sha512-sp, ?l^6, 8 targets, the empty salt")
    say(f"  phase 35: {time.perf_counter() - t_phase:.1f} s")

    # 36. the slice end to end through the CLI
    t_phase = time.perf_counter()
    say(f"== 36. the slice through crack --device cuda; card: {card}")
    g5 = MaskGenerator("?l?l?l?l?l")
    per6, per5 = unit_batches(cli, g6.keyspace), unit_batches(cli, g5.keyspace)
    walls = {}
    for engine, gen, n_lines, key, launches, salt_of in (
            ("sha224", g6, 1, "sha224_mask", per6, None),
            ("ldap-sha", g6, N_TARGETS, "sha1_mask_multi", per6, None),
            ("ldap-md5", g6, N_TARGETS, "md5_mask_multi", per6, None),
            ("mysql323", g6, 1, "mysql323_mask", per6, None),
            ("mysql323", g6, N_TARGETS, "mysql323_mask_probe", per6, None),
            ("sha512-ps", g5, n_group, "sha512-ps_group", per5,
             lambda i: alnum(i % 33)),
            ("sha512-sp", g5, 1, "sha512-sp_group", per5,
             lambda i: alnum(8)),
            ("mssql2005", g6, n_group, "sha1-ps-utf16_group", per6,
             lambda i: alnum(4)),
            ("mssql2000", g6, n_group, "sha1-ps-utf16_group", per6,
             lambda i: alnum(4)),
            ("mssql2012", g5, n_group, "sha512-ps-utf16_group", per5,
             lambda i: alnum(4))):
        say(f"  crack --engine {engine} {gen.mask}, {n_lines} target(s)")
        _, walls[f"{engine}_{n_lines}"] = l_path(
            smoke, cli, engine, gen, n_lines, key, launches, salt_of)
    # sha224 at config 2's shape: 1,000 targets over 2^32 of ?a^7
    skip = int(rng.integers(0, g7.keyspace - CONFIG2_WINDOW))
    say(f"  crack --engine sha224 {MASK_CONFIG2}, {N_TARGETS} targets over "
        f"{CONFIG2_WINDOW} candidates")
    _, walls["sha224_config2"] = l_path(
        smoke, cli, "sha224", g7, N_TARGETS, "sha224_mask_multi",
        unit_batches(cli, CONFIG2_WINDOW), window=CONFIG2_WINDOW, skip=skip)
    # ldap-sha over a wordlist with best64: the sha1 rule core
    words = synthetic_words(OTHER_WORDS)
    wgen = WordlistRulesGenerator(words, load_rules("best64"), 55)
    plant_i = wgen.index_of(OTHER_WORDS - 1, RULE_8OPS)
    plant = wgen.candidate(plant_i)
    line = l_lines("ldap-sha", smoke.get_engine("ldap-sha").hash_batch(
        [plant]), [None])[0]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "words.txt")
        with open(path, "wb") as fh:
            fh.write(b"\n".join(words) + b"\n")
        summary, wall, launches = smoke.crack_lines(
            cli, "ldap-sha", ["-a", "wordlist", "--rules", "best64", path],
            [line], [f"{line}:{encode_plain(plant)}"], OTHER_WORDS * N_RULES,
            kernel_modules())
    check(launches["sha1_rules"] == sum(launches.values()) > 0,
          f"ldap-sha wordlist: launches {launches}")
    walls["ldap-sha_wordlist"] = wall
    # sha224 on the sharded runtime: the probe
    meshes = (make_mesh(1), make_mesh(devices=["cuda:0"] * SHARDS))
    skip = int(rng.integers(0, g7.keyspace - OTHER_WINDOW))
    planted = [g7.candidate(skip + int(i)) for i in
               sorted(set(rng.integers(0, OTHER_WINDOW, 3).tolist()))]
    digests = smoke.get_engine("sha224").hash_batch(planted) + \
        smoke.fillers("sha224", N_TARGETS - len(planted))
    walls["sha224_sharded"] = sharded_path(smoke, cli, "sha224", g7, digests,
                                           planted, skip, OTHER_WINDOW,
                                           meshes)
    say(json.dumps({"slice_l_cli_wall_s": walls, "card": card}))
    say(f"  phase 36: {time.perf_counter() - t_phase:.1f} s")

    # 37. timing at batch 2^24
    t_phase = time.perf_counter()
    say(f"== 37. slice L timing at batch 2^24 (CUDA events, "
        f"{TIMED_LAUNCHES} launches, the SM clock sampled over the phase); "
        f"card: {card}")
    timing = {}
    with SmClock() as clock:
        for key, engine, mode in L_MASK:
            gen, lut = (g7, lut7) if engine == "sha224" else (g6, lut6)
            s = int(rng.integers(0, gen.keyspace // BATCH - 1)) * BATCH
            head = (engine, lut, gen.radices, gen.digits(s), BATCH)
            run = cuda_mask.lanes_a_run(engine, gen.radices)
            if mode == 0:
                miss = digest_words(engine, smoke.get_engine(engine)
                                    .hash_batch([b"\0" * 9])[0])
                args = (*head, miss, 64, BATCH)
                fn, plain_fn = cuda_mask.mask_kernel, cuda_mask.mask_plain
            else:
                table, rows, words_t = smoke.tables(
                    engine, smoke.fillers(engine, N_TARGETS))
                if mode == PROBE:
                    bits, block_bits, k = cuda_mask.probe_rows(table.words)
                    args = (*head, torch.as_tensor(bits.view(np.int32),
                                                   device="cuda"),
                            block_bits, k, words_t, 64, BATCH)
                    fn, plain_fn = cuda_mask.mask_probe_kernel, \
                        cuda_mask.mask_probe_plain
                else:
                    args = (*head, rows, words_t, 64, BATCH)
                    fn, plain_fn = cuda_mask.mask_multi_kernel, \
                        cuda_mask.mask_multi_plain
                maybes = int(fn(*args)[3].item()) / BATCH
            if engine == "mysql323":
                work = opcount.mysql323_ops(
                    gen, None if mode == 0 else
                    (opcount.probe_fill(bits), k),
                    0.0 if mode == 0 else maybes, N_TARGETS)
            elif mode == 0:
                work = opcount.ops_per_candidate(engine, gen.length, run=run)
            elif mode == PROBE:
                work = opcount.probe_ops(engine, gen.length,
                                         opcount.probe_fill(bits), k, maybes,
                                         N_TARGETS, run=run)
            else:
                work = opcount.ops_per_candidate(
                    engine, gen.length, True, bloom.expected_probes(
                        rows.cpu().numpy().view(np.uint32)), maybes,
                    N_TARGETS, run=run)
            ms = smoke.time_launches(fn, args)
            plain = smoke.time_once(plain_fn, args)
            bound = BATCH * work.slots / rate_ops * 1e3
            timing[key] = (ms, plain, bound, {"sm_mhz": None})
            say(f"  {key} {gen.mask}"
                f"{'' if mode == 0 else f', {N_TARGETS} targets'}: "
                f"{ms:.4f} ms/launch = {BATCH / ms / 1e6:.3f} G cand/s; "
                f"bound {bound:.4f} ms ({work.alu:.1f} ALU, {work.add:.1f} "
                f"IADD3, {work.fma:.1f} IMAD = {work.slots:.1f} slots; "
                f"{bound / ms:.1%}); plain version {plain:.2f} ms")
        for variant, engine in L_SALTED:
            dev = smoke.get_engine(engine, "cuda")
            salt = alnum(4 if dev.widen else TIMING_SALT)
            s = int(rng.integers(0, g6.keyspace // BATCH - 1)) * BATCH
            lut = cuda_ext.mapped_lut(g6, "cuda", dev.byte_map)
            miss = digest_words(engine, smoke.get_engine(engine).hash_batch(
                [b"\0" * 9], params={"salt": salt})[0])
            rows, shift = cuda_ext.salted_table(
                variant, g6.length, [(salt, miss)] * n_group, "cuda")
            args = (variant, lut, g6.radices, g6.digits(s), BATCH, shift,
                    rows, 64, BATCH)
            ms = smoke.time_launches(cuda_ext.salted_kernel, args, n=3,
                                     warm=1)
            work = opcount.salted_ops(variant, g6.length, salt, n_group)
            hashes = BATCH * n_group
            bound = hashes * work.slots / rate_ops * 1e3
            key = f"{variant}_group"
            pms, plain_lanes = plain_ms[engine]
            timing[key] = (ms, pms, bound,
                           {"group": n_group, "plain_lanes": plain_lanes,
                            "sm_mhz": None})
            say(f"  {key} ({engine}) ?l^6, a {len(salt)}-byte salt, "
                f"{n_group} targets: {ms:.4f} ms/launch = {ms / n_group:.4f} "
                f"ms per 2^24 hashes = {hashes / ms / 1e6:.3f} G hashes/s; "
                f"bound {bound:.4f} ms ({work.slots:.1f} slots a hash; "
                f"{bound / ms:.1%}); plain version {pms:.1f} ms at "
                f"{plain_lanes} lanes")
    say(f"  the SM clock over the phase: {clock.mhz} MHz (nvidia-smi, "
        f"{len(clock.samples)} samples); card: {card}")
    for key, (ms, _, bound, more) in timing.items():
        more.update(clock_keys(bound, clock.mhz, smoke.clock_mhz))
        if clock.mhz:
            say(f"    {key}: {ms:.4f} ms; kernel at "
                f"{more['bound_ms_at_sm_mhz'] / ms:.1%} of the bound at the "
                "sampled clock")
    say(json.dumps({"slice_l_timing": {k: {"ms": v[0], "plain_ms": v[1],
                                           "bound_ms": v[2], **v[3]}
                                       for k, v in timing.items()},
                    "card": card}))
    say(f"  phase 37: {time.perf_counter() - t_phase:.1f} s")
    return timing


# ---- slice M: target lists of any length -----------------------------------

def m_hex_lines(rows):
    """uint8[N, size] digest bytes -> the file's bytes, a hex line each."""
    import numpy as np
    hexd = np.frombuffer(b"0123456789abcdef", np.uint8)
    n, size = rows.shape
    out = np.empty((n, 2 * size + 1), np.uint8)
    out[:, 0:2 * size:2] = hexd[rows >> 4]
    out[:, 1:2 * size:2] = hexd[rows & 15]
    out[:, -1] = 10
    return out.tobytes()


def m_random_digests(rng, engine: str, n: int):
    """n random digests of ``engine``'s size as uint8[n, size] (mysql323:
    two 31-bit big-endian words, as its oracle gives)."""
    import numpy as np

    from dprf_tpu_torch import get_engine
    size = M_DIGEST_BYTES.get(engine) or get_engine(engine).digest_size
    rows = rng.integers(0, 256, (n, size), dtype=np.uint8)
    if engine == "mysql323":
        rows[:, 0] &= 0x7F
        rows[:, 4] &= 0x7F
    return rows


def m_list(smoke, engine: str, n: int, plants: list):
    """A list of n targets: the planted candidates' digests at the first,
    the last and random positions, random digests elsewhere.  Returns
    (uint8[n, size] digest bytes, the plants' positions)."""
    import numpy as np
    rng = smoke.rng
    digests = smoke.get_engine(engine).hash_batch(plants)
    rows = m_random_digests(rng, engine, n)
    pos = [0, n - 1] + [int(x) + 1 for x in rng.choice(
        n - 2, max(0, len(plants) - 2), replace=False)]
    for p, d in zip(pos, digests):
        rows[p] = np.frombuffer(d, np.uint8)
    return rows, pos[:len(plants)]


def m_rows(engine: str, rows):
    """Digest bytes uint8[N, size] -> the core's uint32 words."""
    import numpy as np
    dt = "<u4" if little_endian(engine) else ">u4"
    return np.ascontiguousarray(rows).view(dt).astype(np.uint32)


def m_bulk_case(smoke, engine, gen, lut, start, offset, nv, plants, n,
                name, max_bytes=None):
    """One bulk-probe case against its plain version at a window offset:
    lanes [offset, nv) of a batch of 2^24 from ``start``, a list of n
    targets with ``plants`` (keyspace indices) planted at the first, last
    and random positions (``m_list``).  Count, (lane, table position)
    pairs and n_maybe equal; the hits are the plants inside the window
    (in the host-verify layout, ``max_bytes`` forced small, every
    survivor is reported at position -1 and the plants among them).
    Returns the probe table."""
    from dprf_tpu_torch.targets import probe
    cm, torch = smoke.cm, smoke.torch
    rows, pos = m_list(smoke, engine, n, [gen.candidate(p) for p in plants])
    pt = probe.build_probe_rows(m_rows(engine, rows), max_bytes=max_bytes,
                                device="cuda")
    state = cm.probe_tensors(pt, "cuda")
    args = (engine, lut, gen.radices, gen.digits(start), nv, *state,
            1 << 16, BATCH)
    got = cm.mask_bulk_kernel(*args, offset=offset)
    want = cm.mask_bulk_plain(*args, offset=offset)
    torch.cuda.synchronize()

    def flat(out):
        pairs = sorted((int(a), int(b)) for a, b in
                       zip(out[1].tolist(), out[2].tolist()) if a >= 0)
        return int(out[0].item()), pairs, int(out[3].item())

    (kc, kp, km), (pc, pp, pm) = flat(got), flat(want)
    key = kname(engine, 3)
    err = max([abs(kc - pc), abs(km - pm)]
              + [abs(a - b) for x, y in zip(kp, pp) for a, b in zip(x, y)])
    inside = [(p - start, i) for p, i in zip(plants, pos)
              if offset <= p - start < nv]
    if pt.table is None:
        lanes = {lane for lane, _ in kp}
        ok = kc == km and all(t == -1 for _, t in kp) and \
            {lane for lane, _ in inside} <= lanes
        hits = f"{kc} survivors at -1"
    else:
        got_hits = sorted((lane, int(pt.order[t])) for lane, t in kp)
        ok = got_hits == sorted(inside)
        hits = f"(lane, target)={got_hits}"
    say(f"  {key} {name}: {pt.mode}, {pt.num_targets} targets, 2^"
        f"{pt.block_bits} blocks, k {pt.k}: kernel count={kc} {hits} "
        f"n_maybe={km} | plain count={pc} n_maybe={pm}")
    check((kc, kp, km) == (pc, pp, pm), f"{key} {name}: kernel and plain "
          "differ")
    check(ok, f"{key} {name}: hits {kp}, expected the plants {inside}")
    smoke.err[key] = max(smoke.err.get(key, 0), err)
    return pt


def m_rules_state(smoke, engine, mode, plants, n, max_bytes=None):
    """A list of n targets for the rules kernel with ``plants``
    (candidates) planted: PROBE, the sorted table and ``probe_rows``'
    bitmap; BULK, a probe table.  Returns (state tensors, order, rows)."""
    from dprf_tpu_torch.ops import compare as cmp_ops
    from dprf_tpu_torch.targets import probe
    torch, cm = smoke.torch, smoke.cm
    rows, pos = m_list(smoke, engine, n, plants)
    words = m_rows(engine, rows)
    if mode == 2:
        table = cmp_ops.table_from_rows(words)
        bits, block_bits, k = cm.probe_rows(table.words)
        return ((torch.as_tensor(bits.view(smoke.np.int32), device="cuda"),
                 block_bits, k, table.tensor("cuda")), table.order, pos)
    pt = probe.build_probe_rows(words, max_bytes=max_bytes, device="cuda")
    return cm.probe_tensors(pt, "cuda"), pt.order, pos


def m_rules_case(smoke, engine, mode, tables, gen, ws, nv, plant_idx, n,
                 name, max_bytes=None) -> float:
    """One list case of the rules kernel (mode 2 or 3) against its plain
    version over words [ws, ws + nv) x every rule (``tables``: the padded
    table, the plain one, lens, bytecode, n_ops; ``gen`` their
    generator), a list of n targets with the candidates at keyspace
    indices ``plant_idx`` planted.  Count, (lane, table position) pairs
    and n_maybe equal; every lane of a planted candidate reported.
    Returns the plain version's ms."""
    from dprf_tpu_torch.ops import cuda_rules
    torch = smoke.torch
    plants = [gen.candidate(i) for i in plant_idx]
    state, _, _ = m_rules_state(smoke, engine, mode, plants, n, max_bytes)
    padded, plain, *rest = tables
    tail = (ws, nv, *state, 1 << 16, RULE_BATCH)
    got = cuda_rules.rules_list_kernel(engine, mode, padded, *rest, *tail,
                                       max_len=gen.max_len)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = cuda_rules.rules_list_plain(engine, mode, plain, *rest, *tail)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    def flat(out):
        pairs = sorted((int(a), int(b)) for a, b in
                       zip(out[1].tolist(), out[2].tolist()) if a >= 0)
        return int(out[0].item()), pairs, int(out[3].item())

    (kc, kp, km), (pc, pp, pm) = flat(got), flat(want)
    key = rname(engine, mode)
    err = max([abs(kc - pc), abs(km - pm)]
              + [abs(a - b) for x, y in zip(kp, pp) for a, b in zip(x, y)])
    gidx = {(ws + lane % RULE_BATCH) * gen.n_rules + lane // RULE_BATCH: t
            for lane, t in kp}
    planted = [i for i in plant_idx
               if ws * gen.n_rules <= i < (ws + nv) * gen.n_rules]
    say(f"  {key} {name}: {n} targets: kernel count={kc} n_maybe={km} "
        f"planted indices {planted} among the hits: "
        f"{all(i in gidx for i in planted)} | plain count={pc} "
        f"n_maybe={pm}")
    check((kc, kp, km) == (pc, pp, pm), f"{key} {name}: kernel and plain "
          "differ")
    check(all(i in gidx for i in planted), f"{key} {name}: a plant missed")
    check(all(gen.candidate(i) in plants for i in gidx) or
          state[3] is None, f"{key} {name}: a hit decodes to another "
          "candidate")
    smoke.err[key] = max(smoke.err.get(key, 0), err)
    return plain_ms


def m_crack(smoke, cli, engine, argv, rows, want, window):
    """crack --device cuda --targets-file over the hex lines of ``rows``
    (uint8[N, size]): argv, the attack's options then its mask or
    wordlist.  Every launch count is set to 0 just before it.  Checks the
    printed lines and the potfile (``want``), rejected=0, rescans=0 and
    tested=``window``; returns (summary, the log, wall s, launches)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "targets.txt")
        pot = os.path.join(tmp, "job.potfile")
        with open(path, "wb") as fh:
            fh.write(m_hex_lines(rows))
        *opts, attack_arg = argv
        args = ["crack", "--device", "cuda", "--engine", engine, *opts,
                attack_arg, "--targets-file", path, "--potfile", pot]
        for mod in kernel_modules():
            mod.reset_launches()
        t0 = time.perf_counter()
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main(args)
        wall = time.perf_counter() - t0
        launches = {k: v for mod in kernel_modules()
                    for k, v in mod.launches.items()}
        pot_lines = open(pot).read().splitlines() \
            if os.path.exists(pot) else []
    out, err = out.getvalue(), err.getvalue()
    check(rc == (0 if want else 1), f"crack {engine} exited {rc}: "
          f"{err[-2000:]}")
    check(sorted(out.splitlines()) == sorted(want),
          f"crack {engine} printed {out.splitlines()}, expected {want}")
    check(sorted(pot_lines) == sorted(want), f"potfile {pot_lines}")
    finished = [ln for ln in err.splitlines() if "job finished" in ln]
    check(len(finished) == 1 and "rejected=0" in finished[0]
          and "rescans=0" in finished[0]
          and f"found={len(want)}/{len(rows)}" in finished[0]
          and f"tested={window}" in finished[0],
          f"{engine}: job summary {finished}")
    return finished[0], err, wall, launches


def m_log(err: str, what: str, key: str) -> float:
    """A float ``key=`` of the first log line holding ``what`` and it."""
    line = next(ln for ln in err.splitlines()
                if what in ln and f" {key}=" in ln)
    return float(re.search(rf" {key}=([\d.]+)", line).group(1))


def m_path(smoke, cli, engine, gen, n, key, n_launches, window=None,
           skip=0, plants=3, argv=None, words=None):
    """crack --device cuda of ``engine`` over a --targets-file of n
    targets, ``plants`` candidates of the window planted at the list's
    first, last and random positions: only ``key`` launches,
    ``n_launches`` times (the worker's batches; None: whatever the
    summary's batches say).  A wordlist job passes ``argv`` (its options
    and the wordlist) and its generator.  Returns (summary, log, wall s)."""
    from dprf_tpu_torch.runtime.potfile import encode_plain
    rng = smoke.rng
    window = window or gen.keyspace - skip
    idx = [skip, skip + window - 1] + [
        skip + int(x) for x in rng.integers(1, window - 1, plants - 2)]
    cands = [gen.candidate(i) for i in idx]
    cands = list(dict.fromkeys(c for c in cands if c is not None))
    rows, _ = m_list(smoke, engine, n, cands)
    digests = smoke.get_engine(engine).hash_batch(cands)
    want = [f"{d.hex()}:{encode_plain(c)}" for d, c in zip(digests, cands)]
    if argv is None:
        argv = (["--skip", str(skip), "--limit", str(window)] if skip
                else []) + [gen.mask]
    summary, err, wall, launches = m_crack(smoke, cli, engine, argv, rows,
                                           want, window)
    batches = int(re.search(r" batches=(\d+)", summary).group(1))
    want_n = batches if n_launches is None else n_launches
    check(launches[key] == want_n == batches
          and sum(launches.values()) == want_n,
          f"{engine}: launches {launches}, {batches} batches, expected "
          f"{want_n} of {key}")
    smoke.path_launches.setdefault(key, launches[key])
    say(f"    {engine} x {n} targets ({key}): {wall:.3f} s wall, "
        f"{summary.split('job finished', 1)[1].strip()}")
    return summary, err, wall


def m_time(smoke, fn, args, kwargs=None) -> float:
    """ms per launch of fn(*args, **kwargs), CUDA events over
    TIMED_LAUNCHES launches after warm-up."""
    kwargs = kwargs or {}
    return smoke.time_launches(lambda: fn(*args, **kwargs), ())


def slice_m(smoke, cli, card, rate_ops, g6, lut6, g7, lut7) -> dict:
    """Phases 38-44: slice M -- target lists of any length: the bulk
    probe of csrc/mask.cu (mode 3, ``<core>_mask_bulk``) and the rules
    kernel's lists (``<core>_rules_probe``, ``<core>_rules_bulk``).
    Returns the timing rows (ms, plain ms, bound ms, bound_by, more) of
    the new instantiations; their main paths' launches go to
    smoke.path_launches."""
    ctx = m_rules_ctx()
    m_kernels(smoke, card, g6, lut6, g7, lut7, ctx)
    m_flat(smoke, card, g7, lut7)
    m_cli(smoke, cli, card, g6, g7, ctx)
    return m_timing(smoke, card, rate_ops, g6, lut6, g7, lut7, ctx)


def m_rules_ctx() -> dict:
    """The rules kernel's inputs of slice M: config 3's word list (the
    reference bench's 2^20 synthetic words), best64, and per max_len (27,
    55) the generator of its first RULE_BATCH words and their tables on
    the card (padded, plain, lens, bytecode, n_ops)."""
    import torch

    from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
    from dprf_tpu_torch.ops import cuda_rules
    from dprf_tpu_torch.rules import load_rules
    best64 = load_rules("best64")
    words = synthetic_words(CONFIG3_WORDS)
    ctx = {"best64": best64, "words": words, "gens": {}, "tables": {}}
    for max_len in (27, 55):
        gen = WordlistRulesGenerator(words[:RULE_BATCH], best64,
                                     max_len=max_len)
        buf, lens = gen.packed_words()
        plain = torch.as_tensor(buf, device="cuda")
        ctx["gens"][max_len] = gen
        ctx["tables"][max_len] = (
            cuda_rules.pad_rows(plain), plain,
            torch.as_tensor(lens, device="cuda"),
            *cuda_rules.rule_tables(best64, "cuda"))
    return ctx


def m_kernels(smoke, card, g6, lut6, g7, lut7, ctx) -> None:
    """Phase 38: every bulk mask instantiation and every list
    instantiation of the rules kernel against its plain version."""
    rng = smoke.rng
    rule_gens, rule_tables = ctx["gens"], ctx["tables"]
    # 38. every new instantiation against its plain version
    t_phase = time.perf_counter()
    say(f"== 38. slice M kernels vs plain at a batch of 2^24 (exact "
        f"equality); card: {card}")
    offset, nv = 12347, BATCH - 17
    for engine in M_MASK_CORES:
        gen, lut = (g6, lut6) if engine == "mysql323" else (g7, lut7)
        start = int(rng.integers(0, gen.keyspace // BATCH - 1)) * BATCH
        late = int(rng.integers(offset + 1, nv - 1))
        plants = [start + offset, start + offset + 1, start + late,
                  start + nv - 1, start + nv, start + offset - 1]
        m_bulk_case(smoke, engine, gen, lut, start, offset, nv, plants,
                    M_CHECK_TARGETS, f"{gen.mask}, window [{offset}, {nv})")
    start = int(rng.integers(0, g7.keyspace // BATCH - 1)) * BATCH
    pt = m_bulk_case(smoke, "ntlm", g7, lut7, start, 0, BATCH,
                     [start, start + 99, start + BATCH - 1], M_CHECK_TARGETS,
                     "?a^7, the host-verify layout (max_bytes 256 KiB)",
                     max_bytes=256 * 1024)
    check(pt.table is None, "max_bytes did not force the host-verify layout")
    for engine in RULE_CORES:
        max_len = 27 if engine == "ntlm" else 55
        gen = rule_gens[max_len]
        nw = gen.n_words
        ws, nvw = 3, nw - 5
        plants = [gen.index_of(ws, 0), gen.index_of(ws + 1, RULE_8OPS),
                  gen.index_of(ws + nvw - 1, N_RULES - 1),
                  gen.index_of(int(rng.integers(ws, ws + nvw)),
                               int(rng.integers(0, N_RULES)))]
        for mode, n in ((2, N_TARGETS), (3, M_CHECK_TARGETS)):
            m_rules_case(smoke, engine, mode, rule_tables[max_len], gen, ws,
                         nvw, plants, n, f"words [{ws}, {ws + nvw}) x best64")
    m_rules_case(smoke, "md5", 3, rule_tables[55], rule_gens[55], 0,
                 RULE_BATCH, [rule_gens[55].index_of(7, 1)],
                 M_CHECK_TARGETS, "the host-verify layout",
                 max_bytes=256 * 1024)
    say(f"  phase 38: {time.perf_counter() - t_phase:.1f} s")


def m_flat(smoke, card, g7, lut7) -> dict:
    """Phase 39: the bulk kernel alone from 10^4 to 10^7 targets (its
    flat ratio), and the Bloom sets, the shared-memory probe and the bulk
    probe at 1,024, 2,048, 4,096 and 8,192 targets (N_BULK's crossover)."""
    import numpy as np
    import torch

    from dprf_tpu_torch.ops import cuda_mask, opcount
    from dprf_tpu_torch.targets import probe
    rng = smoke.rng
    # 39. the bulk kernel alone: flat in the list's length
    t_phase = time.perf_counter()
    say(f"== 39. md5_mask_bulk and ntlm_mask_bulk alone at 10^4..10^7 "
        f"random targets, ?a^7, 2^24 a launch (CUDA events, "
        f"{TIMED_LAUNCHES} launches); the Bloom sets, the shared-memory "
        f"probe and the bulk probe at 1,024-8,192 targets; card: {card}")
    flat = {}
    start = int(rng.integers(0, g7.keyspace // BATCH - 1)) * BATCH
    head = (lut7, g7.radices, g7.digits(start), BATCH)
    for engine in ("md5", "ntlm"):
        times = {}
        for n in M_FLAT_TARGETS:
            t0 = time.perf_counter()
            plants = [start + 5, start + BATCH // 2, start + BATCH - 1]
            rows, pos = m_list(smoke, engine, n,
                               [g7.candidate(p) for p in plants])
            pt = probe.build_probe_rows(m_rows(engine, rows), device="cuda")
            state = cuda_mask.probe_tensors(pt, "cuda")
            built = time.perf_counter() - t0
            args = (engine, *head, *state, 64, BATCH)
            _, lanes, tpos, n_maybe = cuda_mask.mask_bulk_kernel(*args)
            torch.cuda.synchronize()
            hits = sorted((int(a), int(pt.order[b])) for a, b in
                          zip(lanes.tolist(), tpos.tolist()) if a >= 0)
            check(hits == sorted((p - start, i) for p, i in
                                 zip(plants, pos)),
                  f"{engine} x {n}: hits {hits}, plants at {pos}")
            ms = m_time(smoke, cuda_mask.mask_bulk_kernel, args)
            times[n] = ms
            bitmap = 64 << pt.block_bits
            say(f"  {kname(engine, 3)} x {n:>8}: {ms:.4f} ms; bitmap "
                f"{bitmap:,} B ({bitmap / opcount.L2_BYTES:.1%} of L2), "
                f"table {pt.nbytes - bitmap:,} B, k {pt.k}, fp "
                f"{pt.fp_est:.2e}, n_maybe {int(n_maybe.item())}; plants "
                f"at list positions {pos} found; built in {built:.2f} s")
            del state, args
        ratio = max(times.values()) / min(times.values())
        flat[engine] = {"ms": times, "flat_ratio": ratio}
        say(f"  {engine}: flat_ratio {ratio:.3f} (largest / smallest ms "
            f"from 10^4 to 10^7 targets)")
        for n in M_CROSS_TARGETS:
            digests = [r.tobytes() for r in m_random_digests(rng, engine, n)]
            table, rows_t, words_t = smoke.tables(engine, digests)
            bits, block_bits, k = cuda_mask.probe_rows(table.words)
            bits_t = torch.as_tensor(bits.view(np.int32), device="cuda")
            pt = probe.build_probe_table(digests, little_endian(engine),
                                         device="cuda")
            ms_sets = m_time(smoke, cuda_mask.mask_multi_kernel,
                             (engine, *head, rows_t, words_t, 64, BATCH))
            ms_probe = m_time(smoke, cuda_mask.mask_probe_kernel,
                              (engine, *head, bits_t, block_bits, k,
                               words_t, 64, BATCH))
            ms_bulk = m_time(smoke, cuda_mask.mask_bulk_kernel,
                             (engine, *head,
                              *cuda_mask.probe_tensors(pt, "cuda"), 64,
                              BATCH))
            flat[engine][f"cross_{n}"] = {"multi_ms": ms_sets,
                                          "probe_ms": ms_probe,
                                          "bulk_ms": ms_bulk}
            say(f"  {engine} x {n}: _multi {ms_sets:.4f} ms | _probe "
                f"{ms_probe:.4f} ms | _bulk {ms_bulk:.4f} ms (bulk/multi "
                f"{ms_bulk / ms_sets:.3f})")
    say(json.dumps({"slice_m_flat": flat, "n_bulk": cuda_mask.N_BULK,
                    "card": card}))
    say(f"  phase 39: {time.perf_counter() - t_phase:.1f} s")
    return flat


def m_cli(smoke, cli, card, g6, g7, ctx) -> None:
    """Phases 40-43: slice M's main paths through crack --device cuda."""
    from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
    from dprf_tpu_torch.runtime.potfile import encode_plain
    from dprf_tpu_torch.targets import probe
    rng = smoke.rng
    words, best64 = ctx["words"], ctx["best64"]
    # 40-43: the main paths through the CLI
    t_phase = time.perf_counter()
    say(f"== 40. the host-verify layout through crack --device cuda: ntlm "
        f"x {M_CHECK_TARGETS} over {OTHER_WINDOW} of ?a^7, the byte budget "
        f"forced to 512 KiB; card: {card}")
    saved = probe.byte_budget
    probe.byte_budget = lambda device=None: 512 * 1024
    try:
        skip = int(rng.integers(0, g7.keyspace - OTHER_WINDOW))
        summary, err, _ = m_path(smoke, cli, "ntlm", g7, M_CHECK_TARGETS,
                                 "ntlm_mask_bulk", None, OTHER_WINDOW, skip)
    finally:
        probe.byte_budget = saved
    check("mode=host-verify" in err and "host_rejected=" in summary,
          f"host-verify path: {summary}")
    host = {"host_rejected": int(re.search(r"host_rejected=(\d+)",
                                           summary).group(1)),
            "maybes": int(re.search(r"maybes=(\d+)", summary).group(1))}
    say(f"  every hit confirmed by the oracle: {json.dumps(host)}")

    say(f"== 41. config 2 at bulk size: crack --device cuda --engine ntlm "
        f"?a^7 --targets-file of {M_CONFIG2_TARGETS} lines over "
        f"{CONFIG2_WINDOW} candidates; card: {card}")
    skip = int(rng.integers(0, g7.keyspace - CONFIG2_WINDOW))
    summary, err, wall = m_path(
        smoke, cli, "ntlm", g7, M_CONFIG2_TARGETS, "ntlm_mask_bulk",
        unit_batches(cli, CONFIG2_WINDOW), CONFIG2_WINDOW, skip, plants=8)
    config2 = {"targets": M_CONFIG2_TARGETS, "wall_s": wall,
               "parse_s": m_log(err, "target set", "parse_s"),
               "table_bitmap_s": m_log(err, "probe table", "build_s"),
               "setup_s": m_log(err, "worker", "setup_s"),
               "loop_s": float(re.search(r"elapsed=([\d.]+)s",
                                         summary).group(1)),
               "maybes": int(re.search(r"maybes=(\d+)", summary).group(1)),
               "rate": loop_rate(summary)}
    say(f"  config 2 at bulk size: {json.dumps(config2)}")
    smoke.path_launches["ntlm_mask_bulk"] = unit_batches(cli,
                                                         CONFIG2_WINDOW)
    say(f"  the other bulk instantiations: {M_CHECK_TARGETS} targets over "
        f"{OTHER_WINDOW} of ?a^7 (mysql323: the whole ?l^6)")
    for engine in M_MASK_CORES:
        if engine == "ntlm":
            continue
        if engine == "mysql323":
            m_path(smoke, cli, engine, g6, M_CHECK_TARGETS,
                   kname(engine, 3), unit_batches(cli, g6.keyspace))
            continue
        skip = int(rng.integers(0, g7.keyspace - OTHER_WINDOW))
        m_path(smoke, cli, engine, g7, M_CHECK_TARGETS, kname(engine, 3),
               unit_batches(cli, OTHER_WINDOW), OTHER_WINDOW, skip)

    say(f"== 42. config 3 against lists: crack --device cuda -a wordlist "
        f"--rules best64 --targets-file; card: {card}")
    wordlists = {}
    cli_rules = {}
    with tempfile.TemporaryDirectory() as tmp:
        for n_words in (CONFIG3_WORDS, OTHER_WORDS):
            path = os.path.join(tmp, f"words{n_words}.txt")
            with open(path, "wb") as fh:
                fh.write(b"\n".join(words[:n_words]) + b"\n")
            wordlists[n_words] = path
        for engine, n_words, n, mode in M_RULE_PATHS:
            max_len = 27 if engine == "ntlm" else 55
            gen = WordlistRulesGenerator(words[:n_words], best64,
                                         max_len=max_len)
            summary, err, wall = m_path(
                smoke, cli, engine, gen, n, rname(engine, mode), None,
                argv=["-a", "wordlist", "--rules", "best64",
                      wordlists[n_words]])
            cli_rules[f"{engine}_{n_words}x{n}"] = {
                "wall_s": wall, "rate": loop_rate(summary),
                "parse_s": m_log(err, "target set", "parse_s"),
                "setup_s": m_log(err, "worker", "setup_s")}
    say(json.dumps({"slice_m_rules_cli": cli_rules, "card": card}))

    say(f"== 43. dense hits: crack --device cuda --engine md5 ?l^6, "
        f"{M_DENSE_PLANTS} plants in one loop window among "
        f"{M_CHECK_TARGETS} targets, --hit-cap 8; card: {card}")
    idx = sorted(int(x) for x in rng.choice(1 << 28, M_DENSE_PLANTS,
                                             replace=False))
    cands = [g6.candidate(i) for i in idx]
    rows, _ = m_list(smoke, "md5", M_CHECK_TARGETS, cands)
    want = [f"{d.hex()}:{encode_plain(c)}" for d, c in
            zip(smoke.get_engine("md5").hash_batch(cands), cands)]
    summary, err, wall, launches = m_crack(
        smoke, cli, "md5", ["--hit-cap", "8", "--limit", str(1 << 28),
                            g6.mask], rows, want, 1 << 28)
    relaunches = int(re.search(r"relaunches=(\d+)", summary).group(1))
    check(relaunches >= 1 and launches["md5_mask_bulk"]
          == sum(launches.values()) == 16 * (1 + relaunches),
          f"dense hits: {summary}, launches {launches}")
    say(f"  dense hits: relaunches={relaunches} rescans=0 (on the card, "
        f"not the oracle); {wall:.3f} s wall; "
        f"{summary.split('job finished', 1)[1].strip()}")
    say(f"  phases 40-43: {time.perf_counter() - t_phase:.1f} s")
    smoke.m_cli = {"host_verify": host, "config2_bulk": config2,
                   "rules": cli_rules}


def m_timing(smoke, card, rate_ops, g6, lut6, g7, lut7, ctx) -> dict:
    """Phase 44: every new instantiation timed at its main path's list,
    beside its bound, its plain version and the SM clock."""
    import numpy as np

    from dprf_tpu_torch.ops import cuda_mask, cuda_rules, opcount
    from dprf_tpu_torch.targets import probe
    rng = smoke.rng
    rule_gens, rule_tables = ctx["gens"], ctx["tables"]
    best64 = ctx["best64"]
    # 44. timing of every new instantiation at its main path's list
    t_phase = time.perf_counter()
    say(f"== 44. slice M timing at 2^24 a launch (CUDA events, "
        f"{TIMED_LAUNCHES} launches, the SM clock sampled over the phase); "
        f"card: {card}")
    timing = {}
    with SmClock() as clock:
        for engine in M_MASK_CORES:
            gen, lut = (g6, lut6) if engine == "mysql323" else (g7, lut7)
            n = M_CONFIG2_TARGETS if engine == "ntlm" else M_CHECK_TARGETS
            s = int(rng.integers(0, gen.keyspace // BATCH - 1)) * BATCH
            rows = m_random_digests(rng, engine, n)
            pt = probe.build_probe_rows(m_rows(engine, rows), device="cuda")
            args = (engine, lut, gen.radices, gen.digits(s), BATCH,
                    *cuda_mask.probe_tensors(pt, "cuda"), 64, BATCH)
            maybes = int(cuda_mask.mask_bulk_kernel(*args)[3].item()) / BATCH
            ms = m_time(smoke, cuda_mask.mask_bulk_kernel, args)
            plain = smoke.time_once(cuda_mask.mask_bulk_plain, args)
            fill = opcount.probe_fill(pt.bits)
            run = cuda_mask.lanes_a_run(engine, gen.radices)
            work = opcount.mysql323_ops(gen, (fill, pt.k), maybes, n) \
                if engine == "mysql323" else opcount.bulk_ops(
                    engine, gen.length, fill, pt.k, maybes, n, run=run)
            ops_ms = BATCH * work.slots / rate_ops * 1e3
            moved = opcount.bulk_bytes(
                n, smoke.get_engine(engine, "cuda").digest_words,
                pt.block_bits)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            bound = max(ops_ms, bytes_ms)
            bitmap = 64 << pt.block_bits
            timing[kname(engine, 3)] = (
                ms, plain, bound,
                "operations" if ops_ms >= bytes_ms else "bytes",
                {"targets": n, "bitmap_bytes": bitmap,
                 "bitmap_share_of_l2": bitmap / opcount.L2_BYTES,
                 "fill": fill, "k": pt.k})
            say(f"  {kname(engine, 3)} {gen.mask}, {n} targets: {ms:.4f} ms "
                f"= {BATCH / ms / 1e6:.3f} G cand/s; bound {bound:.4f} ms "
                f"(operations {ops_ms:.4f}: {work.slots:.1f} slots; bytes "
                f"{bytes_ms:.4f}: {moved:,} B; {bound / ms:.1%}); bitmap "
                f"{bitmap:,} B = {bitmap / opcount.L2_BYTES:.2%} of the "
                f"50 MB L2, fill {fill:.3f}, k {pt.k}; plain {plain:.2f} ms")
        for engine in RULE_CORES:
            max_len = 27 if engine == "ntlm" else 55
            gen = rule_gens[max_len]
            padded, plain_t, *rest = rule_tables[max_len]
            counts = opcount.rule_lengths(
                *(a[:OTHER_WORDS] for a in gen.packed_words()), best64,
                max_len)
            counts = {k: c * RULE_BATCH // OTHER_WORDS
                      for k, c in counts.items()}
            for mode in (2, 3):
                n = N_TARGETS if mode == 2 else (
                    M_CONFIG2_TARGETS if engine == "ntlm"
                    else M_CHECK_TARGETS)
                state, _, _ = m_rules_state(smoke, engine, mode, [], n)
                tail = (0, RULE_BATCH, *state, 64, RULE_BATCH)
                maybes = int(cuda_rules.rules_list_kernel(
                    engine, mode, padded, *rest, *tail,
                    max_len=max_len)[3].item())
                ms = m_time(smoke, cuda_rules.rules_list_kernel,
                            (engine, mode, padded, *rest, *tail),
                            {"max_len": max_len})
                plain = smoke.time_once(cuda_rules.rules_list_plain,
                                        (engine, mode, plain_t, *rest,
                                         *tail))
                bits = state[0].cpu().numpy().view(np.uint32)
                fill = opcount.probe_fill(bits)
                cands = RULE_BATCH * N_RULES
                work = opcount.rules_list_ops(engine, counts, fill, state[2],
                                              maybes / cands, n)
                ops_ms = work.slots / rate_ops * 1e3
                moved = RULE_BATCH * (max_len + 4) + opcount.bulk_bytes(
                    n, smoke.get_engine(engine, "cuda").digest_words,
                    state[1])
                bytes_ms = moved / HBM_BYTES_PER_S * 1e3
                bound = max(ops_ms, bytes_ms)
                key = rname(engine, mode)
                timing[key] = (ms, plain, bound,
                               "operations" if ops_ms >= bytes_ms
                               else "bytes",
                               {"targets": n, "bitmap_bytes": bits.nbytes,
                                "fill": fill, "k": state[2]})
                say(f"  {key}, {n} targets: {ms:.4f} ms = "
                    f"{cands / ms / 1e6:.3f} G cand/s; bound {bound:.4f} "
                    f"ms ({work.slots / cands:.1f} slots a candidate; "
                    f"{bound / ms:.1%}); bitmap {bits.nbytes:,} B, fill "
                    f"{fill:.3f}; plain {plain:.2f} ms")
    say(f"  the SM clock over the phase: {clock.mhz} MHz (nvidia-smi, "
        f"{len(clock.samples)} samples); card: {card}")
    for key, (ms, _, bound, _, more) in timing.items():
        more.update(clock_keys(bound, clock.mhz, smoke.clock_mhz))
    say(json.dumps({"slice_m_timing": {k: {"ms": v[0], "plain_ms": v[1],
                                           "bound_ms": v[2], **v[4]}
                                       for k, v in timing.items()},
                    "card": card}))
    say(f"  phase 44: {time.perf_counter() - t_phase:.1f} s")
    return timing


# ---- slice N: wordlist+rules of the salted, nested and Kerberos engines ----

def n_words_file(tmp: str, words: list, name: str) -> str:
    """``words`` written one a line to ``tmp``/``name``; returns the path."""
    path = os.path.join(tmp, name)
    with open(path, "wb") as fh:
        fh.write(b"\n".join(words) + b"\n")
    return path


def n_plants(rng, gen, n: int) -> list:
    """n keyspace indices of ``gen`` whose rule keeps its candidate, of at
    least N_PLANT_LEN bytes, in this order: the first word under rule 0,
    the last word under the last rule, random ones; each candidate once.
    (A short candidate -- a truncation of a word -- comes from hundreds of
    (word, rule) lanes, past a launch's hit buffer.)"""
    idx = [gen.index_of(0, 0), gen.keyspace - 1]
    while len(idx) < 4 * n:
        idx.append(int(rng.integers(1, gen.keyspace - 1)))
    out, seen = [], set()
    for i in idx:
        c = gen.candidate(i)
        if c is not None and len(c) >= N_PLANT_LEN and c not in seen:
            seen.add(c)
            out.append(i)
    return out[:n]


def n_dense_plant(gen, n_words: int = 256) -> tuple:
    """(keyspace index, lanes): the first of ``gen``'s first n_words
    words under rule 0 that the most rules keep as it is, and the number
    of those rules (at least 2)."""
    best = (0, 0)
    for w in range(n_words):
        word = gen.candidate(gen.index_of(w, 0))
        same = sum(gen.candidate(gen.index_of(w, r)) == word
                   for r in range(gen.n_rules))
        best = max(best, (same, -w))
    check(best[0] >= 2, f"no word of the first {n_words} that two rules "
          "keep as it is")
    return gen.index_of(-best[1], 0), best[0]


def n_crack(smoke, cli, engine, words_path, lines, want, extra=()):
    """crack --device cuda -a wordlist --rules best64 of ``engine`` over
    the hashfile of ``lines``, every launch count set to 0 just before it:
    the printed lines and the potfile are ``want``, the summary has
    rejected=0 (and rescans=0 where the worker counts them: the rules
    worker).  Returns (summary, launches, wall s)."""
    with tempfile.TemporaryDirectory() as tmp:
        hashes = os.path.join(tmp, "hashes.txt")
        pot = os.path.join(tmp, "job.potfile")
        with open(hashes, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        args = ["crack", "--device", "cuda", "--engine", engine, "-a",
                "wordlist", words_path, hashes, "--rules", "best64",
                "--potfile", pot, *extra]
        for mod in kernel_modules():
            mod.reset_launches()
        t0 = time.perf_counter()
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main(args)
        wall = time.perf_counter() - t0
        launches = {k: v for mod in kernel_modules()
                    for k, v in mod.launches.items() if v}
        pot_lines = open(pot).read().splitlines() \
            if os.path.exists(pot) else []
    out, err = out.getvalue(), err.getvalue()
    check(rc == 0, f"crack {engine} exited {rc}: {err[-2000:]}")
    check(sorted(out.splitlines()) == sorted(want),
          f"crack {engine} printed {out.splitlines()}, expected {want}")
    check(sorted(pot_lines) == sorted(want), f"potfile {pot_lines}")
    finished = [ln for ln in err.splitlines() if "job finished" in ln]
    check(len(finished) == 1 and "rejected=0" in finished[0]
          and ("rescans=" not in finished[0] or "rescans=0" in finished[0])
          and f"found={len(want)}/{len(lines)}" in finished[0],
          f"{engine}: job summary {finished}")
    return finished[0], launches, wall


def n_path(smoke, cli, engine, words_path, gen, lines, want, key, n_windows,
           what, extra=()):
    """One CLI path of slice N: only ``key`` launches, ``n_windows`` times
    (a group's or the list's launches a word window) and once more per
    relaunch of an overflowing window (the rules worker's); prints and
    records its launches."""
    summary, launches, wall = n_crack(smoke, cli, engine, words_path, lines,
                                      want, extra)
    batches = int(re.search(r" batches=(\d+)", summary).group(1))
    relaunched = re.search(r" relaunches=(\d+)", summary)
    relaunched = int(relaunched.group(1)) if relaunched else 0
    check(launches == {key: batches} and batches == n_windows + relaunched,
          f"{engine}: launches {launches}, {batches} batches, expected "
          f"{n_windows} of {key} and {relaunched} relaunches")
    smoke.path_launches.setdefault(key, launches[key])
    say(f"    {engine} {what} ({key}): {wall:.3f} s wall, "
        f"{summary.split('job finished', 1)[1].strip()}")
    return summary, wall


def n_ctx() -> dict:
    """Slice N's inputs: config 3's word list (the reference bench's 2^20
    synthetic words), best64, and per max_len (23: the salted cores' with
    room for a 32-byte salt; 25 MSSQL's; 27 Kerberos'; 55 the other cores')
    the generator of the first RULE_BATCH words, their tables on the
    card (padded, plain, lens, bytecode, n_ops) and their rule outputs'
    lengths ({length: candidates}, ``opcount.rule_lengths`` over the
    first OTHER_WORDS, scaled to RULE_BATCH), for the bounds."""
    import torch

    from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
    from dprf_tpu_torch.ops import cuda_rules, opcount
    from dprf_tpu_torch.rules import load_rules
    best64 = load_rules("best64")
    words = synthetic_words(CONFIG3_WORDS)
    ctx = {"best64": best64, "words": words, "gens": {}, "tables": {},
           "lengths": {}}
    for max_len in (23, 25, 27, 55):
        gen = WordlistRulesGenerator(words[:RULE_BATCH], best64,
                                     max_len=max_len)
        buf, lens = gen.packed_words()
        ctx["lengths"][max_len] = {
            n: c * RULE_BATCH // OTHER_WORDS
            for n, c in opcount.rule_lengths(
                buf[:OTHER_WORDS], lens[:OTHER_WORDS], best64,
                max_len).items()}
        plain = torch.as_tensor(buf, device="cuda")
        ctx["gens"][max_len] = gen
        ctx["tables"][max_len] = (
            cuda_rules.pad_rows(plain), plain,
            torch.as_tensor(lens, device="cuda"),
            *cuda_rules.rule_tables(best64, "cuda"))
    return ctx


def n_group(smoke, tail, gen, plants, n_targets, salt_len=None,
            upper=False):
    """A group of ``tail`` whose targets ``plants`` (keyspace indices of
    ``gen``, one a target from its first) are planted, the rest filled
    with digests (tickets) no candidate reaches: (rows int32 on the card,
    the launch's parameters, each target's planted candidate or None).
    Salts: alphanumeric, 0..32 bytes for ``ps`` (salt_len None), else
    ``salt_len`` each; MSSQL's 4 bytes."""
    import numpy as np

    from dprf_tpu_torch.ops import cuda_ext, cuda_krb5, cuda_rules
    rng, torch = smoke.rng, smoke.torch
    cands = [gen.candidate(i) for i in plants] + \
        [None] * (n_targets - len(plants))
    if tail == cuda_rules.KRB5:
        oracle = smoke.get_engine("krb5tgs")
        lines = [krb5_line(rng, c if c is not None
                           else b"not-a-word-" + b"%d" % i, False,
                           int(rng.integers(60, 200)))
                 for i, c in enumerate(cands)]
        tgts = [cuda_krb5.target_kernel_args(oracle.parse_target(ln))
                for ln in lines]
        rows = cuda_krb5.ticket_rows(tgts)
        return (torch.as_tensor(rows.view(np.int32), device="cuda"),
                {"msg_type": tgts[0].msg_type}, cands, lines)
    algo, order = tail.split("-")[:2]
    group = []
    for i, c in enumerate(cands):
        n = 4 if tail.endswith("-utf16") else salt_len if salt_len \
            is not None else int(rng.integers(0, 33))
        salt = bytes(rng.choice(np.frombuffer(ALNUM, np.uint8), n))
        msg = (c if c is not None else b"\xff" * 60)
        if upper:
            msg = bytes(x - 32 if 97 <= x <= 122 else x for x in msg)
        if tail.endswith("-utf16"):
            msg = bytes(b for x in msg for b in (x, 0))
        digest = hashlib.new(algo, msg + salt if order == "ps"
                             else salt + msg).digest()
        group.append((salt, digest_words(algo, digest)))
    rows = cuda_ext.salted_rule_rows(tail, group, gen.max_len)
    params = {"shift": salt_len or 0} if order == "sp" else {}
    if upper:
        params["upper"] = True
    return (torch.as_tensor(rows.view(np.int32), device="cuda"), params,
            cands, None)


def n_group_case(smoke, tail, ctx, max_len, plants, n_targets, name,
                 salt_len=None, upper=False):
    """One group tail against the plants at the main path's launch
    (RULE_BATCH words x best64, ``n_targets`` targets): every planted
    (index, target) among the hits, every hit a plant's candidate; then
    against its plain version on the same launch (a larger group's first
    N_CHECK_TARGETS targets, its plants among them), count, (lane,
    target) pairs and per-target counts equal.  Returns (rows, params,
    the plain version's ms there) for the timing."""
    from dprf_tpu_torch.ops import cuda_rules
    torch = smoke.torch
    gen, (padded, plain, *rest) = ctx["gens"][max_len], \
        ctx["tables"][max_len]
    rows, params, cands, rows_lines = n_group(smoke, tail, gen, plants,
                                              n_targets, salt_len, upper)
    key = f"{tail}_rules"
    cap = 64 * n_targets
    kc, kl, kt, ktc = cuda_rules.rules_group_kernel(
        tail, padded, *rest, 0, RULE_BATCH, rows, cap, RULE_BATCH,
        max_len=max_len, **params)
    torch.cuda.synchronize()
    pairs = sorted((int(a), int(b)) for a, b in zip(kl.tolist(), kt.tolist())
                   if a >= 0)
    hits = {((lane % RULE_BATCH) * gen.n_rules + lane // RULE_BATCH, t)
            for lane, t in pairs}
    check(int(kc.item()) == len(pairs) <= cap, f"{key} {name}: count "
          f"{int(kc.item())}, {len(pairs)} pairs")
    check(all((p, t) in hits for t, p in enumerate(plants)),
          f"{key} {name}: a plant missed: {sorted(hits)[:8]}")
    # a hit is its target's plant (MSSQL 2000: up to ASCII case); a
    # Kerberos survivor that is not is a maybe the oracle must reject
    same = (lambda a, b: a.upper() == b.upper()) if upper else \
        (lambda a, b: a == b)
    other = [(g, t) for g, t in hits
             if cands[t] is None or not same(gen.candidate(g), cands[t])]
    if tail == cuda_rules.KRB5:
        oracle = smoke.get_engine("krb5tgs")
        check(not any(oracle.verify(gen.candidate(g), oracle.parse_target(
            rows_lines[t])) for g, t in other), f"{key} {name}: a maybe "
            "that is not its ticket's plant opens it")
    else:
        check(not other, f"{key} {name}: a hit is not its target's plant")
    check(ktc.tolist() == [sum(1 for _, t in hits if t == j)
                           for j in range(n_targets)],
          f"{key} {name}: tcount {ktc.tolist()}")
    k = min(n_targets, N_CHECK_TARGETS)
    check_rows, ccap = rows[:k], 64 * k
    got = (kc, kl, kt, ktc) if k == n_targets else \
        cuda_rules.rules_group_kernel(
            tail, padded, *rest, 0, RULE_BATCH, check_rows, ccap,
            RULE_BATCH, max_len=max_len, **params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = cuda_rules.rules_group_plain(
        tail, plain, *rest, 0, RULE_BATCH, check_rows, ccap, RULE_BATCH,
        **params)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3

    def flat(out):
        return (int(out[0].item()), sorted(
            (int(a), int(b)) for a, b in zip(out[1].tolist(), out[2].tolist())
            if a >= 0), out[3].tolist())

    (gc, gp, gt), (pc, pp, pt) = flat(got), flat(want)
    err = max([abs(gc - pc)] + [abs(a - b) for x, y in zip(gp, pp)
                                for a, b in zip(x, y)]
              + [abs(a - b) for a, b in zip(gt, pt)])
    check((gc, gp, gt) == (pc, pp, pt), f"{key} {name}: kernel and plain "
          f"differ at 2^24 candidates, {k} targets: {gc} {gp[:4]} | {pc} "
          f"{pp[:4]}")
    check(gc >= min(len(plants), k), f"{key} {name}: {gc} hits over {k} "
          "targets, fewer than its plants")
    smoke.err[key] = max(smoke.err.get(key, 0), err)
    say(f"  {key} {name}: {n_targets} targets, 2^24 candidates: "
        f"{len(pairs)} hits, every plant found | the plain version on the "
        f"same launch, {k} of its targets: {gc} hits, equal, "
        f"{plain_ms:.0f} ms")
    return rows, params, plain_ms


def n_kernels(smoke, card, ctx) -> dict:
    """Phase 45: every new instantiation of the rules kernel against its
    plain version on the card at the main path's launch (2^24 candidates
    = RULE_BATCH words x best64): each new core with one target (its
    plants at word 0 under rule 0 and at the last valid word of a
    partial window under the last rule), 1,000 targets (the shared-memory
    probe) and N_BULK_TARGETS (the bulk probe); each group tail at its
    main path's group.  Returns the group inputs for the timing."""
    rng = smoke.rng
    t_phase = time.perf_counter()
    say(f"== 45. slice N kernels vs plain at 2^24 candidates (exact "
        f"equality); card: {card}")
    gen, tables = ctx["gens"][55], ctx["tables"][55]
    ws, nvw = 3, RULE_BATCH - 5
    for engine in N_CORES:
        plants = [gen.index_of(ws, 0), gen.index_of(ws + nvw - 1,
                                                     N_RULES - 1)]
        for p in plants:
            smoke.rules_case(engine, gen, tables, ws, nvw, [p],
                             f"words [{ws}, {ws + nvw}) x best64, plant {p}")
        plants += [gen.index_of(int(rng.integers(ws, ws + nvw)),
                                int(rng.integers(0, N_RULES)))]
        for mode, n in ((2, N_TARGETS), (3, N_BULK_TARGETS)):
            m_rules_case(smoke, engine, mode, tables, gen, ws, nvw, plants,
                         n, f"words [{ws}, {ws + nvw}) x best64")
    groups = {}
    for tail, max_len, n, salt_len, upper in N_GROUP_CASES:
        g = ctx["gens"][max_len]
        plants = n_plants(rng, g, min(4, n))
        groups[tail, n, upper] = n_group_case(
            smoke, tail, ctx, max_len, plants, n,
            f"max_len {max_len}" + (", uppercase" if upper else "")
            + (f", {salt_len}-byte salts" if salt_len else ""),
            salt_len, upper)
    say(f"  phase 45: {time.perf_counter() - t_phase:.1f} s")
    return groups


def n_cli(smoke, cli, card, ctx) -> None:
    """Phase 46: the slice's main paths through ``crack --device cuda -a
    wordlist --rules best64``, each with every launch count set to 0 just
    before it and read just after: only its instantiation, once per
    (group and) word window; rejected=0 and every plant found."""
    import numpy as np

    from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
    from dprf_tpu_torch.ops import cuda_mask, cuda_rules
    from dprf_tpu_torch.runtime.potfile import encode_plain
    rng = smoke.rng
    t_phase = time.perf_counter()
    say(f"== 46. slice N through crack --device cuda -a wordlist --rules "
        f"best64; card: {card}")
    words, best64 = ctx["words"], ctx["best64"]
    windows = -(-CONFIG3_WORDS // RULE_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        full = n_words_file(tmp, words, "config3.txt")
        other = n_words_file(tmp, words[:OTHER_WORDS], "other.txt")

        def gen_of(engine, n_words):
            return WordlistRulesGenerator(
                words[:n_words], best64,
                max_len=smoke.get_engine(engine).max_candidate_len)

        def hex_line(engine, d):
            return "*" + d.hex().upper() if engine == "mysql41" else d.hex()

        # the cores: one target, 1,000 (probe), N_BULK_TARGETS (bulk)
        for engine in N_CORES:
            oracle = smoke.get_engine(engine)
            for mode, n in ((0, 1), (2, N_TARGETS), (3, N_BULK_TARGETS)):
                n_words = CONFIG3_WORDS if (engine, mode) in N_FULL_CORES \
                    else OTHER_WORDS
                gen = gen_of(engine, n_words)
                plants = n_plants(rng, gen, 1 if n == 1 else 3)
                cands = [gen.candidate(i) for i in plants]
                digests = oracle.hash_batch(cands)
                fill = [bytes(r) for r in m_random_digests(
                    rng, engine, n - len(cands))]
                fill = [d for d in fill if d not in digests]
                lines = [hex_line(engine, d) for d in digests + fill]
                want = [f"{hex_line(engine, d)}:{encode_plain(c)}"
                        for d, c in zip(digests, cands)]
                n_path(smoke, cli, engine, full if n_words == CONFIG3_WORDS
                       else other, gen, lines, want, rname(engine, mode),
                       -(-n_words // RULE_BATCH),
                       f"x {n} target(s) over {n_words} words")
        def salted_job(engine, gen, plants, n, salt_len):
            """n targets of ``engine``, the first planted: (lines, want)."""
            oracle = smoke.get_engine(engine)
            lines, want = [], []
            for i in range(n):
                nb = 4 if engine.startswith("mssql") else salt_len \
                    if salt_len is not None else int(rng.integers(2, 33))
                salt = bytes(rng.choice(np.frombuffer(ALNUM, np.uint8), nb))
                c = gen.candidate(plants[i]) if i < len(plants) \
                    else b"#miss%d" % i
                d = oracle.hash_batch([c], params={"salt": salt})[0]
                line = n_salted_line(engine, d, salt)
                lines.append(line)
                if i < len(plants):
                    want.append(f"{line}:{encode_plain(c)}")
            return lines, want

        # the salted tails
        for engine, tail, n, n_words, salt_len in N_SALTED_PATHS:
            gen = gen_of(engine, n_words)
            plants = n_plants(rng, gen, min(n, 8))
            lines, want = salted_job(engine, gen, plants, n, salt_len)
            groups = -(-n // cuda_rules.tail_geometry(tail)[0]) \
                if tail.endswith("ps") or tail.endswith("utf16") else 1
            n_path(smoke, cli, engine, full if n_words == CONFIG3_WORDS
                   else other, gen, lines, want, f"{tail}_rules",
                   groups * -(-n_words // RULE_BATCH),
                   f"x {n} targets over {n_words} words")
        # dense hits: md5-ps x 4 salts at --hit-cap 1, one plant a word
        # that several rules keep as it is: the (group, window) overflows
        # its buffer of 4 and is relaunched on the card, nothing rescanned
        gen = gen_of("md5-ps", OTHER_WORDS)
        dense, lanes = n_dense_plant(gen)
        plants = [dense] + [p for p in n_plants(rng, gen, 4) if
                            gen.candidate(p) != gen.candidate(dense)][:3]
        lines, want = salted_job("md5-ps", gen, plants, 4, None)
        summary, _ = n_path(
            smoke, cli, "md5-ps", other, gen, lines, want, "md5-ps_rules",
            1, f"x 4 targets over {OTHER_WORDS} words, --hit-cap 1, "
            f"{gen.candidate(dense)!r} at {lanes} (word, rule) lanes",
            ("--hit-cap", "1"))
        check(" relaunches=1 " in summary and " rescans=0" in summary,
              f"dense hits: {summary}")
        # Kerberos: the Kerberoast and an AS-REP roast
        for engine, n, n_words in (("krb5tgs", KERBEROAST_TICKETS,
                                    CONFIG3_WORDS), ("krb5asrep", 1,
                                                     OTHER_WORDS)):
            gen = gen_of(engine, n_words)
            plants = n_plants(rng, gen, min(n, 4))
            lines, want = [], []
            for i in range(n):
                c = gen.candidate(plants[i]) if i < len(plants) \
                    else b"#miss%d" % i
                line = krb5_line(rng, c, engine == "krb5asrep",
                                 int(rng.integers(1000, 1500)))
                lines.append(line)
                if i < len(plants):
                    want.append(f"{line}:{encode_plain(c)}")
            n_path(smoke, cli, engine, full if n_words == CONFIG3_WORDS
                   else other, gen, lines, want, "krb5_rules",
                   -(-n_words // RULE_BATCH),
                   f"x {n} tickets over {n_words} words")
    check(windows == 4, "config 3's windows")
    say(f"  N_BULK = {cuda_mask.N_BULK}; phase 46: "
        f"{time.perf_counter() - t_phase:.1f} s")


def n_salted_line(engine: str, digest: bytes, salt: bytes) -> str:
    """A salted target line of ``engine`` in its own format."""
    if engine.startswith("mssql"):
        case = digest.hex() if engine == "mssql2000" else ""
        return f"0x0100{salt.hex()}{case}{digest.hex()}".upper()
    return f"{digest.hex()}:$HEX[{salt.hex()}]"


def n_timing(smoke, card, rate_ops, sms, ctx, groups) -> dict:
    """Phase 47: each new instantiation per launch with CUDA events at
    the main path's launch (2^24 candidates; a list of the path's size, a
    group of its size) beside its bound (``rules_ops``,
    ``rules_list_ops``, ``rules_salted_ops``, ``rules_krb5_bound``) and
    its plain version (timed in phase 45; a larger group's over its first
    N_CHECK_TARGETS targets, the kernel timed there too); then the K3
    instantiations beside PERF.md's row 4.  Returns the kernels line's
    rows by name, (ms, plain ms, bound ms, bound_by, more), and the other
    group cases' (md5-ps and MSSQL 2000 at one target)."""
    import numpy as np

    from dprf_tpu_torch.ops import cuda_ext, cuda_rules, opcount
    torch = smoke.torch
    t_phase = time.perf_counter()
    say(f"== 47. slice N timing, CUDA events, {TIMED_LAUNCHES} launches "
        f"each; card: {card}")
    timing = {}
    with SmClock() as clock:
        counts55 = ctx["lengths"][55]
        padded, plain, *rest = ctx["tables"][55]
        for engine in N_CORES:
            key = rname(engine)
            miss = digest_words(engine, smoke.get_engine(engine).hash_batch(
                [b"\0" * 9])[0])
            args = (engine, padded, *rest, 0, RULE_BATCH, miss, 64,
                    RULE_BATCH)
            ms = smoke.time_launches(
                lambda: cuda_rules.rules_kernel(*args, max_len=55), ())
            pms = n_plain_ms(smoke, cuda_rules.rules_plain,
                             (engine, plain, *args[2:]))
            bound = opcount.rules_ops(engine, counts55).slots / rate_ops * 1e3
            timing[key] = (ms, pms, bound, "operations", {})
            for mode, n in ((2, N_TARGETS), (3, N_BULK_TARGETS)):
                key = rname(engine, mode)
                state, _, rows = m_rules_state(smoke, engine, mode, [], n)
                largs = (engine, mode, padded, *rest, 0, RULE_BATCH, *state,
                         64, RULE_BATCH)
                ms = smoke.time_launches(
                    lambda: cuda_rules.rules_list_kernel(*largs, max_len=55),
                    ())
                pms = n_plain_ms(smoke, cuda_rules.rules_list_plain,
                                 (engine, mode, plain, *largs[3:]))
                words = state[0].cpu().numpy().view(np.uint32)
                work = opcount.rules_list_ops(
                    engine, counts55, opcount.probe_fill(words), state[2],
                    0.0, n)
                bound = work.slots / rate_ops * 1e3
                timing[key] = (ms, pms, bound, "operations",
                               {"targets": n})
        for tail, max_len, n, salt_len, upper in N_GROUP_CASES:
            # a tail's first case is its row of the kernels line, the
            # others are named by their group
            key = f"{tail}_rules"
            if key in timing:
                key += f" x{n}" + (" uppercase" if upper else "")
            rows, params, pms = groups[tail, n, upper]
            padded, _, *rest = ctx["tables"][max_len]
            counts = ctx["lengths"][max_len]

            def launch(r):
                return cuda_rules.rules_group_kernel(
                    tail, padded, *rest, 0, RULE_BATCH, r, 64 * r.shape[0],
                    RULE_BATCH, max_len=max_len, **params)

            ms = smoke.time_launches(launch, (rows,),
                                     n=max(3, TIMED_LAUNCHES // n), warm=1)
            k = min(n, N_CHECK_TARGETS)
            more = {"targets": n, "plain_input": f"{RULE_BATCH} words x "
                    "best64, " + (f"{n} targets" if k == n else
                                  f"the first {k} of the {n} targets")}
            if k < n:
                more["ms_at_plain_input"] = smoke.time_launches(
                    launch, (rows[:k],), n=max(3, TIMED_LAUNCHES // k),
                    warm=1)
            if tail == cuda_rules.KRB5:
                lim = opcount.rules_krb5_bound(counts, n, sms,
                                               smoke.clock_mhz * 1e6)
                bound = max(lim.values()) * 1e3
                more["bound_limit"] = max(lim, key=lim.get)
            else:
                work = opcount.rules_salted_ops(
                    tail, counts, cuda_ext.rule_row_salts(tail, rows))
                bound = work.slots / rate_ops * 1e3
            timing[key] = (ms, pms, bound, "operations", more)
        for engine in RULE_CORES:
            key = rname(engine)
            tab = ctx["tables"][27 if engine == "ntlm" else 55]
            args = (engine, tab[0], *tab[2:], 0, RULE_BATCH, digest_words(
                engine, smoke.get_engine(engine).hash_batch([b"\0" * 9])[0]),
                64, RULE_BATCH)
            ms = smoke.time_launches(
                lambda: cuda_rules.rules_kernel(
                    *args, max_len=27 if engine == "ntlm" else 55), ())
            say(f"  {key} (slice K3, unchanged): {ms:.4f} ms per 2^24; "
                f"PERF.md row 4 (slice K3, in turns): {PERF_ROW4_MS[key]:.4f} "
                f"ms ({ms / PERF_ROW4_MS[key]:.3f}x)")
    for key, (ms, pms, bound, _, more) in timing.items():
        more.update(clock_keys(bound, clock.mhz, smoke.clock_mhz))
        per = f" ({ms / more['targets']:.4f} ms per 2^24 hashes)" \
            if key.split("_")[0] in N_TAILS and more.get("targets", 1) > 1 \
            else ""
        at = f", the kernel there {more['ms_at_plain_input']:.4f} ms" \
            if "ms_at_plain_input" in more else ""
        say(f"  {key}: {ms:.4f} ms per launch of 2^24 candidates{per}; "
            f"bound {bound:.4f} ms ({bound / ms:.1%}); plain version "
            f"{pms:.1f} ms" + (f" ({more['plain_input']}{at})"
                               if "plain_input" in more else ""))
    say(f"  the SM clock over the phase: {clock.mhz} MHz (nvidia-smi, "
        f"{len(clock.samples)} samples); card: {card}")
    say(json.dumps({"slice_n_timing": {k: {"ms": v[0], "plain_ms": v[1],
                                           "bound_ms": v[2], **v[4]}
                                       for k, v in timing.items()},
                    "card": card}))
    say(f"  phase 47: {time.perf_counter() - t_phase:.1f} s")
    return timing


def n_plain_ms(smoke, fn, args) -> float:
    """ms of one call of a plain version, synchronised."""
    torch = smoke.torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def slice_n(smoke, cli, card, rate_ops, sms) -> dict:
    """Phases 45-47: slice N -- wordlist+rules on the card for the
    salted, nested and Kerberos etype-23 engines and for sha224 and
    mysql323 (csrc/rules.cu's two new cores, csrc/rules_nested.cu,
    csrc/rules_group.cu).  Returns the timing rows of the new
    instantiations; their main paths' launches go to
    smoke.path_launches."""
    ctx = n_ctx()
    groups = n_kernels(smoke, card, ctx)
    n_cli(smoke, cli, card, ctx)
    return n_timing(smoke, card, rate_ops, sms, ctx, groups)


# ---- slice O: wordlist+rules for the wide cores ---------------------------

def o_packed(words) -> tuple:
    """A list of equal-length words as packed arrays (uint8[N, L], their
    lengths int32[N])."""
    import numpy as np
    buf = np.frombuffer(b"".join(words), np.uint8).reshape(len(words), -1)
    return buf, np.full(len(words), buf.shape[1], np.int32)


def o_long_words(rng, n: int, max_len: int) -> tuple:
    """n random printable words of max_len - O_LONG_SPAN + 1 .. max_len
    bytes, as packed arrays (uint8[n, max_len], int32[n]), the first of
    them max_len bytes long."""
    import numpy as np
    lens = rng.integers(max(1, max_len - O_LONG_SPAN + 1), max_len + 1, n)
    lens[0] = max_len
    buf = rng.integers(33, 127, (n, max_len), dtype=np.uint8)
    buf[np.arange(max_len)[None, :] >= lens[:, None]] = 0
    return buf, lens.astype(np.int32)


def o_ctx(smoke) -> dict:
    """Slice O's inputs: best64 and, by key, a generator of RULE_BATCH
    words and its tables on the card (padded, plain, lens, bytecode,
    n_ops): each path's max_len (``O_MAX_LEN``) over config 3's words,
    and ("long", w) over ``o_long_words`` at a core's widest w (and the
    sha512 salts' 79); the rule outputs' lengths ({length: candidates},
    ``opcount.rule_lengths`` over the first OTHER_WORDS words, scaled to
    RULE_BATCH), by key, for the bounds -- config 3's 8-letter words
    grow to the same lengths at every max_len of the slice, so one count
    serves them."""
    import numpy as np
    import torch

    from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
    from dprf_tpu_torch.ops import cuda_rules, opcount
    from dprf_tpu_torch.rules import load_rules
    best64 = load_rules("best64")
    words = synthetic_words(CONFIG3_WORDS)
    ctx = {"best64": best64, "words": words, "gens": {}, "tables": {},
           "lengths": {}}
    short_buf, short_lens = o_packed(words[:RULE_BATCH])
    counts = None
    keys = sorted(set(O_MAX_LEN.values())) + [
        ("long", w) for w in sorted(set(O_WIDEST.values()) | {79})]
    for key in keys:
        if isinstance(key, tuple):
            max_len = key[1]
            buf, lens = o_long_words(smoke.rng, RULE_BATCH, max_len)
        else:
            max_len = key
            buf = np.zeros((RULE_BATCH, max_len), np.uint8)
            buf[:, :short_buf.shape[1]] = short_buf
            lens = short_lens
        gen = WordlistRulesGenerator(rules=best64, max_len=max_len,
                                     packed=(buf, lens))
        if not isinstance(key, tuple):
            if counts is None:
                counts = {n: c * RULE_BATCH // OTHER_WORDS
                          for n, c in opcount.rule_lengths(
                              buf[:OTHER_WORDS], lens[:OTHER_WORDS], best64,
                              max_len).items()}
            ctx["lengths"][key] = counts
        plain = torch.as_tensor(buf, device="cuda")
        ctx["gens"][key] = gen
        ctx["tables"][key] = (
            cuda_rules.pad_rows(plain), plain,
            torch.as_tensor(lens, device="cuda"),
            *cuda_rules.rule_tables(best64, "cuda"))
    return ctx


def o_kernels(smoke, card, ctx) -> dict:
    """Phase 48: every new instantiation against its plain version on the
    card at the main path's launch (2^24 candidates = RULE_BATCH words x
    best64): each core at its path's max_len with one target (planted at
    the last valid word of a partial window under the last rule), over
    words of up to its widest (a word of 111 or rate - 1 bytes kept as it
    is planted, through the sha3 name for the sponge: the pad byte 0x06
    and 0x80 in one byte), and with 1,000 targets (the shared-memory
    probe) and N_BULK_TARGETS (the bulk probe); each sha512 tail at its
    main path's group (checked on its first N_CHECK_TARGETS targets), and
    sha512-ps over words of up to 79 bytes beside salts of 0-32.  Returns
    the plain versions' ms and the group inputs for the timing."""
    rng = smoke.rng
    t_phase = time.perf_counter()
    say(f"== 48. slice O kernels vs plain at 2^24 candidates (exact "
        f"equality); card: {card}")
    ws, nvw = 3, RULE_BATCH - 5
    plain_ms = {}
    for core in O_CORES:
        gen, tables = ctx["gens"][O_MAX_LEN[core]], \
            ctx["tables"][O_MAX_LEN[core]]
        last = gen.index_of(ws + nvw - 1, N_RULES - 1)
        plain_ms[rname(core)] = smoke.rules_case(
            core, gen, tables, ws, nvw, [last],
            f"max_len {gen.max_len}, words [{ws}, {ws + nvw}) x best64, "
            "the last valid word under the last rule")
        widest = O_WIDEST[core]
        lgen, ltab = ctx["gens"]["long", widest], \
            ctx["tables"]["long", widest]
        word = next(w for w in range(ws, ws + nvw)
                    if len(lgen.candidate(lgen.index_of(w, 0))) == widest)
        smoke.rules_case(O_SHA3.get(core, core), lgen, ltab, ws, nvw,
                         [lgen.index_of(word, 0)],
                         f"words of {widest - O_LONG_SPAN + 1}-{widest} "
                         f"bytes, word {word} of {widest} bytes under ':'",
                         core=core)
        plants = [gen.index_of(ws, 0), last,
                  gen.index_of(int(rng.integers(ws, ws + nvw)),
                               int(rng.integers(0, N_RULES)))]
        for mode, n in ((2, N_TARGETS), (3, N_BULK_TARGETS)):
            plain_ms[rname(core, mode)] = m_rules_case(
                smoke, core, mode, tables, gen, ws, nvw, plants, n,
                f"max_len {gen.max_len}, words [{ws}, {ws + nvw}) x best64")
    groups = {}
    for tail, max_len, n, salt_len in O_GROUP_CASES:
        plants = n_plants(rng, ctx["gens"][max_len], min(4, n))
        groups[tail] = n_group_case(
            smoke, tail, ctx, max_len, plants, n, f"max_len {max_len}"
            + (f", {salt_len}-byte salts" if salt_len else ""), salt_len)
    long79 = {k: {79: ctx[k]["long", 79]} for k in ("gens", "tables")}
    n_group_case(smoke, "sha512-ps", long79, 79,
                 n_plants(rng, long79["gens"][79], 4), 64,
                 f"words of {79 - O_LONG_SPAN + 1}-79 bytes, salts of 0-32")
    say(f"  phase 48: {time.perf_counter() - t_phase:.1f} s")
    return plain_ms, groups


def o_salted_line(engine: str, digest: bytes, salt: bytes) -> str:
    """A sha512 salted target line of ``engine`` in its own format."""
    if engine.startswith("mssql"):
        return f"0x0200{salt.hex()}{digest.hex()}".upper()
    return f"{digest.hex()}:$HEX[{salt.hex()}]"


def o_cli(smoke, cli, card, ctx) -> None:
    """Phase 49: the slice's main paths through ``crack --device cuda -a
    wordlist --rules best64``, each with every launch count set to 0
    just before it and read just after: only its instantiation, once per
    (group and) word window; plants at the job's first index, its last
    and random ones (one target: its last), rejected=0 and every plant
    found.  sha512 with one target and 1,000, sha3-256 and keccak-224
    with one, over config 3's 2^20 words; every other instantiation over
    OTHER_WORDS (the sponge's one-target paths through the sha3 names,
    its lists through the keccak names); sha512-ps x slice D's 1,000
    salts (2-32 bytes), mssql2012 x 256 logins, sha512-sp x one."""
    import numpy as np

    from dprf_tpu_torch.generators.wordlist import WordlistRulesGenerator
    from dprf_tpu_torch.ops import cuda_rules
    from dprf_tpu_torch.runtime.potfile import encode_plain
    rng = smoke.rng
    t_phase = time.perf_counter()
    say(f"== 49. slice O through crack --device cuda -a wordlist --rules "
        f"best64; card: {card}")
    words, best64 = ctx["words"], ctx["best64"]
    with tempfile.TemporaryDirectory() as tmp:
        full = n_words_file(tmp, words, "config3.txt")
        other = n_words_file(tmp, words[:OTHER_WORDS], "other.txt")

        def gen_of(engine, n_words):
            return WordlistRulesGenerator(
                words[:n_words], best64,
                max_len=smoke.get_engine(engine).max_candidate_len)

        for core in O_CORES:
            for mode, n in ((0, 1), (2, N_TARGETS), (3, N_BULK_TARGETS)):
                engine = O_ONE_TARGET.get(core, core) if mode == 0 \
                    else core.replace("keccak", "keccak-")
                n_words = CONFIG3_WORDS if (engine, n) in O_FULL_PATHS \
                    else OTHER_WORDS
                gen = gen_of(engine, n_words)
                plants = n_plants(rng, gen, 3)
                if n == 1:
                    plants = plants[1:2]
                cands = [gen.candidate(i) for i in plants]
                oracle = smoke.get_engine(engine)
                digests = oracle.hash_batch(cands)
                fill = [bytes(r) for r in m_random_digests(
                    rng, engine, n - len(cands))]
                fill = [d for d in fill if d not in digests]
                lines = [d.hex() for d in digests + fill]
                want = [f"{d.hex()}:{encode_plain(c)}"
                        for d, c in zip(digests, cands)]
                n_path(smoke, cli, engine, full if n_words == CONFIG3_WORDS
                       else other, gen, lines, want, rname(core, mode),
                       -(-n_words // RULE_BATCH),
                       f"x {n} target(s) over {n_words} words")
        for engine, tail, n, salt_len in (
                ("sha512-ps", "sha512-ps", N_SALTED, None),
                ("mssql2012", "sha512-ps-utf16", 256, 4),
                ("sha512-sp", "sha512-sp", 1, 11)):
            gen = gen_of(engine, OTHER_WORDS)
            plants = n_plants(rng, gen, min(n, 8))
            oracle = smoke.get_engine(engine)
            lines, want = [], []
            for i in range(n):
                nb = salt_len if salt_len is not None else \
                    int(rng.integers(2, 33))
                salt = bytes(rng.choice(np.frombuffer(ALNUM, np.uint8), nb))
                c = gen.candidate(plants[i]) if i < len(plants) \
                    else b"#miss%d" % i
                d = oracle.hash_batch([c], params={"salt": salt})[0]
                line = o_salted_line(engine, d, salt)
                lines.append(line)
                if i < len(plants):
                    want.append(f"{line}:{encode_plain(c)}")
            groups = -(-n // cuda_rules.tail_geometry(tail)[0]) \
                if not tail.endswith("-sp") else 1
            n_path(smoke, cli, engine, other, gen, lines, want,
                   f"{tail}_rules", groups * -(-OTHER_WORDS // RULE_BATCH),
                   f"x {n} targets over {OTHER_WORDS} words")
    say(f"  phase 49: {time.perf_counter() - t_phase:.1f} s")


def o_timing(smoke, card, rate_ops, ctx, plain_ms, groups, bounds) -> dict:
    """Phase 50: each new instantiation per launch with CUDA events at
    the main path's launch (2^24 candidates at its path's max_len; a list
    of the path's size, a group of its size) beside its bound
    (``rules_ops``, ``rules_list_ops``, ``rules_salted_ops`` with each
    target's own salt), its plain version (timed in phase 48; a group's
    over its first N_CHECK_TARGETS targets, the kernel timed there too),
    its registers, shared memory and resident blocks.  ``bounds``: each
    tail's ``rules_salted_ops`` a target, futures.  Returns the kernels
    line's rows by name, (ms, plain ms, bound ms, bound_by, more)."""
    import numpy as np

    from dprf_tpu_torch.ops import cuda_rules, opcount
    t_phase = time.perf_counter()
    say(f"== 50. slice O timing, CUDA events, {TIMED_LAUNCHES} launches "
        f"each; card: {card}")
    timing = {}
    with SmClock() as clock:
        for core in O_CORES:
            max_len = O_MAX_LEN[core]
            counts = ctx["lengths"][max_len]
            padded, _, *rest = ctx["tables"][max_len]
            miss = digest_words(core, smoke.get_engine(core).hash_batch(
                [b"\0" * 9])[0])
            args = (core, padded, *rest, 0, RULE_BATCH, miss, 64, RULE_BATCH)
            ms = smoke.time_launches(
                lambda: cuda_rules.rules_kernel(*args, max_len=max_len), ())
            bound = opcount.rules_ops(core, counts).slots / rate_ops * 1e3
            smem = cuda_rules.shared_bytes(core)
            timing[rname(core)] = (ms, plain_ms[rname(core)], bound,
                                   "operations", {
                                       "shared_bytes": smem,
                                       "blocks_per_sm":
                                           cuda_rules.blocks_per_sm(core)})
            for mode, n in ((2, N_TARGETS), (3, N_BULK_TARGETS)):
                key = rname(core, mode)
                state, _, _ = m_rules_state(smoke, core, mode, [], n)
                largs = (core, mode, padded, *rest, 0, RULE_BATCH, *state,
                         64, RULE_BATCH)
                ms = smoke.time_launches(
                    lambda: cuda_rules.rules_list_kernel(*largs,
                                                         max_len=max_len), ())
                words = state[0].cpu().numpy().view(np.uint32)
                work = opcount.rules_list_ops(
                    core, counts, opcount.probe_fill(words), state[2], 0.0, n)
                smem = cuda_rules.list_shared_bytes(core, mode, state[1])
                timing[key] = (ms, plain_ms[key], work.slots / rate_ops * 1e3,
                               "operations", {
                                   "targets": n, "shared_bytes": smem,
                                   "blocks_per_sm": cuda_rules.blocks_per_sm(
                                       core, mode, smem)})
        for tail, max_len, n, _ in O_GROUP_CASES:
            key = f"{tail}_rules"
            rows, params, pms = groups[tail]
            padded, _, *rest = ctx["tables"][max_len]

            def launch(r):
                return cuda_rules.rules_group_kernel(
                    tail, padded, *rest, 0, RULE_BATCH, r, 64 * r.shape[0],
                    RULE_BATCH, max_len=max_len, **params)

            ms = smoke.time_launches(launch, (rows,),
                                     n=max(3, TIMED_LAUNCHES // n), warm=1)
            k = min(n, N_CHECK_TARGETS)
            smem = cuda_rules.group_shared_bytes(tail, n)
            more = {"targets": n, "plain_input": f"{RULE_BATCH} words x "
                    "best64, " + (f"{n} targets" if k == n else
                                  f"the first {k} of the {n} targets"),
                    "shared_bytes": smem,
                    "blocks_per_sm": cuda_rules.group_blocks_per_sm(tail,
                                                                    smem)}
            if k < n:
                more["ms_at_plain_input"] = smoke.time_launches(
                    launch, (rows[:k],), n=max(3, TIMED_LAUNCHES // k),
                    warm=1)
            works = [f.result() for f in bounds[tail]]
            work = opcount.Work(sum(w.alu for w in works),
                                sum(w.add for w in works),
                                sum(w.fma for w in works))
            timing[key] = (ms, pms, work.slots / rate_ops * 1e3,
                           "operations", more)
    for key, (ms, pms, bound, _, more) in timing.items():
        more.update(clock_keys(bound, clock.mhz, smoke.clock_mhz))
        more["registers"] = smoke.registers.get(key)
        per = f" ({ms / more['targets']:.4f} ms per 2^24 hashes)" \
            if key.split("_rules")[0] in O_TAILS and more["targets"] > 1 \
            else ""
        at = f", the kernel there {more['ms_at_plain_input']:.4f} ms" \
            if "ms_at_plain_input" in more else ""
        say(f"  {key}: {ms:.4f} ms per launch of 2^24 candidates{per}; "
            f"bound {bound:.4f} ms ({bound / ms:.1%}); plain version "
            f"{pms:.1f} ms" + (f" ({more['plain_input']}{at})"
                               if "plain_input" in more else "")
            + f"; {more['registers']} registers, {more['shared_bytes']} B "
            f"shared, {more['blocks_per_sm']} blocks of "
            f"{cuda_rules.THREADS} an SM")
    say(f"  the SM clock over the phase: {clock.mhz} MHz (nvidia-smi, "
        f"{len(clock.samples)} samples); card: {card}")
    say(json.dumps({"slice_o_timing": {k: {"ms": v[0], "plain_ms": v[1],
                                           "bound_ms": v[2], **v[4]}
                                       for k, v in timing.items()},
                    "card": card}))
    say(f"  phase 50: {time.perf_counter() - t_phase:.1f} s")
    return timing


def slice_o(smoke, cli, card, rate_ops) -> dict:
    """Phases 48-50: slice O -- wordlist+rules on the card for sha512,
    sha384 and their salted names and the 13 sha3/keccak names
    (csrc/rules_wide.cu).  Returns the timing rows of the new
    instantiations; their main paths' launches go to
    smoke.path_launches.  The salted tails' bounds, each target's own
    salt at each rule output's length (~13 ms of the host a pair for
    sha512), are counted by a pool of processes while phase 49 runs."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from dprf_tpu_torch.ops import cuda_ext, opcount
    ctx = o_ctx(smoke)
    plain_ms, groups = o_kernels(smoke, card, ctx)
    with ProcessPoolExecutor(max(1, min(8, (os.cpu_count() or 2) - 1)),
                             multiprocessing.get_context("spawn")) as pool:
        bounds = {tail: [pool.submit(opcount.rules_salted_ops, tail,
                                     ctx["lengths"][max_len], [salt])
                         for salt in cuda_ext.rule_row_salts(
                             tail, groups[tail][0])]
                  for tail, max_len, _, _ in O_GROUP_CASES}
        o_cli(smoke, cli, card, ctx)
        return o_timing(smoke, card, rate_ops, ctx, plain_ms, groups,
                        bounds)


if __name__ == "__main__":
    main()
